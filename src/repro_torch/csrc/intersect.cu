// intersect: per-lane keyed lower bound of candidates in pulled rows.
//
// Replaces src/repro/kernels/intersect/intersect.py::intersect_pallas (the
// Pallas TPU kernel of the split pull lane, called from
// core/engine.py::_pull_compute with pull_kernel "split").
//
// For row b and lane k < L: the candidate key (qd, qh, qi)[b, k] is
// lower-bounded in the row (row_d, row_h, row_i)[b, 0:n] under the
// (degree, hash as unsigned, id) order, where n = clamp(ln[b], 0, L).
// Output pos[b, k] in [0, n]. The TPU kernel ran a fixed ceil(log2 L) + 1
// steps over vectors of lanes; with n <= L that is the exact lower bound,
// which `while (lo < hi)` reaches here in as many steps as the row needs.
//
// Design: one block per row (grid-stride over rows), as wedge_intersect.cu
// does. The block stages the row's n-long prefix (12 bytes a key: 5 KB at
// L = 421) in shared memory, then each thread takes lanes k, k + blockDim,
// ...: it reads its candidate (neighbouring k read neighbouring addresses)
// and binary-searches the staged row. Rows too wide for 48 KB of shared
// memory are searched in device memory instead.
//
// What bounds it on an H100: the bytes — the 12 * B * L candidate words the
// split lane stages in device memory (the fused wedge_intersect never
// writes them), the probed row keys and 4 * B * L of output, at 3.35 TB/s.
//
// Built by repro_torch/kernels/_cuda.py with nvcc for sm_90a; C interface
// for ctypes. Returns cudaGetLastError() of the launch.
#include <cuda_runtime.h>

__device__ __forceinline__ bool key_less(int d, unsigned h, int i,
                                         int qd, unsigned qh, int qi) {
  return d < qd || (d == qd && (h < qh || (h == qh && i < qi)));
}

__global__ void intersect_kernel(const int* __restrict__ row_d,
                                 const unsigned* __restrict__ row_h,
                                 const int* __restrict__ row_i,
                                 const int* __restrict__ ln,
                                 const int* __restrict__ qd,
                                 const unsigned* __restrict__ qh,
                                 const int* __restrict__ qi, long long B,
                                 int L, int use_smem, int* __restrict__ pos) {
  extern __shared__ int smem[];
  int* s_d = smem;
  unsigned* s_h = (unsigned*)(smem + L);
  int* s_i = smem + 2 * L;
  for (long long b = blockIdx.x; b < B; b += gridDim.x) {
    const int raw = ln[b];
    const int n = raw < 0 ? 0 : (raw > L ? L : raw);
    const long long row0 = b * (long long)L;
    const int* rd = row_d + row0;
    const unsigned* rh = row_h + row0;
    const int* ri = row_i + row0;
    if (use_smem) {
      __syncthreads();  // the previous row's searches are done with smem
      for (int j = threadIdx.x; j < n; j += blockDim.x) {
        s_d[j] = rd[j];
        s_h[j] = rh[j];
        s_i[j] = ri[j];
      }
      __syncthreads();
      rd = s_d;
      rh = s_h;
      ri = s_i;
    }
    for (int k = threadIdx.x; k < L; k += blockDim.x) {
      const long long at = row0 + k;
      const int cd = qd[at];
      const unsigned ch = qh[at];
      const int cid = qi[at];
      int lo = 0, hi = n;
      while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (key_less(rd[mid], rh[mid], ri[mid], cd, ch, cid)) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      pos[at] = lo;
    }
  }
}

extern "C" int tripoll_intersect(const void* row_d, const void* row_h,
                                 const void* row_i, const void* ln,
                                 const void* qd, const void* qh,
                                 const void* qi, long long B, int L,
                                 void* pos, void* stream) {
  const int threads = 128;
  const size_t smem = (size_t)3 * L * sizeof(int);
  const int use_smem = smem <= 48 * 1024;
  const long long max_blocks = 1LL << 20;
  const unsigned blocks = (unsigned)(B < max_blocks ? B : max_blocks);
  intersect_kernel<<<blocks, threads, use_smem ? smem : 0,
                     (cudaStream_t)stream>>>(
      (const int*)row_d, (const unsigned*)row_h, (const int*)row_i,
      (const int*)ln, (const int*)qd, (const unsigned*)qh, (const int*)qi, B,
      L, use_smem, (int*)pos);
  return (int)cudaGetLastError();
}
