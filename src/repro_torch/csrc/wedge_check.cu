// wedge_check: keyed lower bound of each push query in its owner's row.
//
// Replaces src/repro/kernels/wedge_check/wedge_check.py::wedge_check_pallas
// (the Pallas TPU kernel of the push lane, called from
// core/engine.py::_answer_push_queries).
//
// For query b of shard s it returns the lower-bound position of the key
// (qd, qh, qi) in the slice [lo, hi) of shard s's key arrays, under the
// (degree, hash as unsigned, id) order; an empty slice (lo >= hi) gives lo.
// The TPU kernel ran a fixed ceil(log2 E) + 1 steps with the keys pinned
// in VMEM; here the keys stay in device memory and L2 (12 bytes a key,
// 1.2 M keys a shard at R-MAT scale 18). One launch covers all S shards:
// grid.y is the shard, whose key arrays start at s * E.
//
// What bounds it on an H100: the bytes are few (24 a query plus 12 a
// probed key: 0.003 ms at 3.35 TB/s for the 262,144 queries of a scale-18
// push superstep), so the chain of dependent loads of each search sets
// the time: up to 9-10 round trips on a row of 421 keys.
//
// Design: a thread a query (the queries of one wave fill the card), and a
// branch-free binary lifting on the (d, h) word from the highest power of
// two <= the row length: a probe is two 4-byte loads, one 64-bit compare
// and a conditional add, and the lanes of a warp on rows of one length
// step alike. Row keys that tie the query's (d, h) follow, ordered by id;
// a walk over them (one step where the row holds the query's own vertex,
// almost never more) finishes the exact lower bound, so ids are read only
// there. At the scale-18 cell's largest push superstep (tools/kernel_ab.py,
// PERF.md) it takes 0.009 ms against 0.011 ms for a branching binary
// search that compares all three fields each probe. Tried on the same
// inputs and dropped: a warp-cooperative search (a warp settles its 32
// queries in turn, each by a ballot over 32 pivots of the row and one over
// the chosen 1/32: 0.056 ms, the queries of a warp serialise), and 4-way
// and 8-way searches (three or seven probes a round trip: 0.010 and
// 0.012 ms, the probes' bytes outweigh the shorter chain).
//
// Built by repro_torch/kernels/_cuda.py with nvcc for sm_90a; C interface
// for ctypes. Returns cudaGetLastError() of the launch.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// (d, h) as one word whose signed order is (d signed, h unsigned)
__device__ __forceinline__ long long dh_word(int d, unsigned h) {
  return (long long)(((unsigned long long)(unsigned)d << 32) | h);
}

__global__ void __launch_bounds__(kThreads)
    wedge_check_kernel(const int* __restrict__ kd,
                       const unsigned* __restrict__ kh,
                       const int* __restrict__ ki, long long E,
                       const int* __restrict__ lo, const int* __restrict__ hi,
                       const int* __restrict__ qd,
                       const unsigned* __restrict__ qh,
                       const int* __restrict__ qi, long long B,
                       int* __restrict__ out) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const long long s = blockIdx.y;
  const long long q = s * B + b;
  const int* d_s = kd + s * E;
  const unsigned* h_s = kh + s * E;
  const int* i_s = ki + s * E;
  const int l = lo[q], h = hi[q];
  const long long t = dh_word(qd[q], qh[q]);
  int p = l;
  if (l < h) {
    for (int step = 1 << (31 - __clz(h - l)); step; step >>= 1) {
      const int m = p + step - 1;
      if (m < h && dh_word(d_s[m], h_s[m]) < t) p += step;
    }
    const int ti = qi[q];
    while (p < h && dh_word(d_s[p], h_s[p]) == t && i_s[p] < ti) ++p;
  }
  out[q] = p;
}

}  // namespace

extern "C" int tripoll_wedge_check(const void* kd, const void* kh,
                                   const void* ki, long long S, long long E,
                                   const void* lo, const void* hi,
                                   const void* qd, const void* qh,
                                   const void* qi, long long B, void* out,
                                   void* stream) {
  dim3 grid((unsigned)((B + kThreads - 1) / kThreads), (unsigned)S);
  wedge_check_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int*)kd, (const unsigned*)kh, (const int*)ki, E,
      (const int*)lo, (const int*)hi, (const int*)qd, (const unsigned*)qh,
      (const int*)qi, B, (int*)out);
  return (int)cudaGetLastError();
}
