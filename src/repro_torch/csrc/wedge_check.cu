// wedge_check: keyed lower bound of each push query in its owner's row.
//
// Replaces src/repro/kernels/wedge_check/wedge_check.py::wedge_check_pallas
// (the Pallas TPU kernel of the push lane, called from
// core/engine.py::_answer_push_queries).
//
// For query b of shard s it returns the lower-bound position of the key
// (qd, qh, qi) in the slice [lo, hi) of shard s's key arrays, under the
// (degree, hash as unsigned, id) order. The TPU kernel ran a fixed
// ceil(log2 E) + 1 steps with the keys pinned in VMEM; here one thread runs
// `while (lo < hi)`, which gives the same lower bound, and the keys stay in
// device memory and L2 (12 bytes a key; 1.2 M keys a shard at R-MAT scale
// 18, so every shard's keys fit in the 50 MB L2 together).
//
// One launch covers all S shards: grid.y is the shard, whose key arrays
// start at s * E. What bounds it on an H100: each query is a chain of about
// log2(row length) dependent loads, so the kernel is latency-bound, far
// above its bytes bound (24 bytes a query plus 12 a probed key, at
// 3.35 TB/s). One thread per query keeps the most chains in flight.
//
// Built by repro_torch/kernels/_cuda.py with nvcc for sm_90a; C interface
// for ctypes. Returns cudaGetLastError() of the launch.
#include <cuda_runtime.h>

__device__ __forceinline__ bool key_less(int d, unsigned h, int i,
                                         int qd, unsigned qh, int qi) {
  return d < qd || (d == qd && (h < qh || (h == qh && i < qi)));
}

__global__ void wedge_check_kernel(const int* __restrict__ kd,
                                   const unsigned* __restrict__ kh,
                                   const int* __restrict__ ki,
                                   long long E,
                                   const int* __restrict__ lo,
                                   const int* __restrict__ hi,
                                   const int* __restrict__ qd,
                                   const unsigned* __restrict__ qh,
                                   const int* __restrict__ qi,
                                   long long B,
                                   int* __restrict__ out) {
  long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  long long s = blockIdx.y;
  long long q = s * B + b;
  const int* d_s = kd + s * E;
  const unsigned* h_s = kh + s * E;
  const int* i_s = ki + s * E;
  int l = lo[q], h = hi[q];
  const int td = qd[q];
  const unsigned th = qh[q];
  const int ti = qi[q];
  while (l < h) {
    int mid = (int)(((long long)l + (long long)h) >> 1);
    // the reference gathers with clamped indices; rows lie inside [0, E)
    long long m = mid < 0 ? 0 : (mid >= E ? E - 1 : mid);
    if (key_less(d_s[m], h_s[m], i_s[m], td, th, ti)) {
      l = mid + 1;
    } else {
      h = mid;
    }
  }
  out[q] = l;
}

extern "C" int tripoll_wedge_check(const void* kd, const void* kh,
                                   const void* ki, long long S, long long E,
                                   const void* lo, const void* hi,
                                   const void* qd, const void* qh,
                                   const void* qi, long long B, void* out,
                                   void* stream) {
  const int threads = 256;
  dim3 grid((unsigned)((B + threads - 1) / threads), (unsigned)S);
  wedge_check_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>(
      (const int*)kd, (const unsigned*)kh, (const int*)ki, E,
      (const int*)lo, (const int*)hi, (const int*)qd, (const unsigned*)qh,
      (const int*)qi, B, (int*)out);
  return (int)cudaGetLastError();
}
