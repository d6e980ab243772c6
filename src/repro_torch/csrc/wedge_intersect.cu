// wedge_intersect: fused candidate addressing + lower bound in pulled rows.
//
// Replaces src/repro/kernels/wedge_intersect/wedge_intersect.py::
// wedge_intersect_pallas (the Pallas TPU kernel of the pull lane, called
// from core/engine.py::_pull_compute with pull_kernel "auto"/"fused").
//
// For pulled edge b and lane k < L: idx = clamp(e[b] + 1 + k, 0, E - 1);
// the candidate key (kd, kh, ki)[idx] is lower-bounded in the edge's pulled
// row (row_d, row_h, row_i)[b, 0:ln[b]] under the (degree, hash as
// unsigned, id) order. Outputs pos[b, k] and ci[b, k] = ki[idx].
//
// Design: one block per pulled edge (grid-stride over edges). The block
// stages the edge's row prefix of ln <= Lr keys in shared memory (12 bytes a
// key: 5 KB at Lr = 421), then each thread takes lanes k, k + blockDim, ...:
// it gathers its candidate from device memory (neighbouring k read
// neighbouring addresses) and binary-searches the staged row. Rows wider
// than fit in 48 KB are searched in device memory instead. ln <= Lr always
// holds on the engine's path; the row reads are clamped to Lr all the same.
//
// What bounds it on an H100: the bytes — 8 * B * L of outputs (the
// engine's pull window pads every edge to L lanes), plus the candidate keys
// and the probed row keys, at 3.35 TB/s — and the dependent loads of each
// lane's search, which the staged row turns into shared-memory reads.
//
// Built by repro_torch/kernels/_cuda.py with nvcc for sm_90a; C interface
// for ctypes. Returns cudaGetLastError() of the launch.
#include <cuda_runtime.h>

__device__ __forceinline__ bool key_less(int d, unsigned h, int i,
                                         int qd, unsigned qh, int qi) {
  return d < qd || (d == qd && (h < qh || (h == qh && i < qi)));
}

__global__ void wedge_intersect_kernel(const int* __restrict__ kd,
                                       const unsigned* __restrict__ kh,
                                       const int* __restrict__ ki,
                                       long long E,
                                       const int* __restrict__ e,
                                       const int* __restrict__ row_d,
                                       const unsigned* __restrict__ row_h,
                                       const int* __restrict__ row_i,
                                       const int* __restrict__ ln,
                                       long long B, int Lr, int L,
                                       int use_smem,
                                       int* __restrict__ pos,
                                       int* __restrict__ ci) {
  extern __shared__ int smem[];
  int* s_d = smem;
  unsigned* s_h = (unsigned*)(smem + Lr);
  int* s_i = smem + 2 * Lr;
  for (long long b = blockIdx.x; b < B; b += gridDim.x) {
    const int n = ln[b];
    const int n_load = n < 0 ? 0 : (n > Lr ? Lr : n);
    const long long row0 = b * (long long)Lr;
    const int* rd = row_d + row0;
    const unsigned* rh = row_h + row0;
    const int* ri = row_i + row0;
    if (use_smem) {
      __syncthreads();  // the previous edge's searches are done with smem
      for (int j = threadIdx.x; j < n_load; j += blockDim.x) {
        s_d[j] = rd[j];
        s_h[j] = rh[j];
        s_i[j] = ri[j];
      }
      __syncthreads();
      rd = s_d;
      rh = s_h;
      ri = s_i;
    }
    const long long eb = e[b];
    for (int k = threadIdx.x; k < L; k += blockDim.x) {
      long long idx = eb + 1 + k;
      idx = idx < 0 ? 0 : (idx >= E ? E - 1 : idx);
      const int cd = kd[idx];
      const unsigned ch = kh[idx];
      const int cid = ki[idx];
      int lo = 0, hi = n;
      while (lo < hi) {
        int mid = (int)(((long long)lo + (long long)hi) >> 1);
        int m = mid < 0 ? 0 : (mid >= Lr ? Lr - 1 : mid);
        if (key_less(rd[m], rh[m], ri[m], cd, ch, cid)) {
          lo = mid + 1;
        } else {
          hi = mid;
        }
      }
      pos[b * (long long)L + k] = lo;
      ci[b * (long long)L + k] = cid;
    }
  }
}

extern "C" int tripoll_wedge_intersect(const void* kd, const void* kh,
                                       const void* ki, long long E,
                                       const void* e, const void* row_d,
                                       const void* row_h, const void* row_i,
                                       const void* ln, long long B, int Lr,
                                       int L, void* pos, void* ci,
                                       void* stream) {
  const int threads = 128;
  const size_t smem = (size_t)3 * Lr * sizeof(int);
  const int use_smem = smem <= 48 * 1024;
  const long long max_blocks = 1LL << 20;
  const unsigned blocks = (unsigned)(B < max_blocks ? B : max_blocks);
  wedge_intersect_kernel<<<blocks, threads, use_smem ? smem : 0,
                           (cudaStream_t)stream>>>(
      (const int*)kd, (const unsigned*)kh, (const int*)ki, E, (const int*)e,
      (const int*)row_d, (const unsigned*)row_h, (const int*)row_i,
      (const int*)ln, B, Lr, L, use_smem, (int*)pos, (int*)ci);
  return (int)cudaGetLastError();
}
