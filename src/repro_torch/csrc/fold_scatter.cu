// fold_count_max: one pass of count scatter-add and packed-row scatter-max;
// ring_set: last-writer-wins scatter-set into a carried table (at the end).
//
// Replaces src/repro/kernels/fold_scatter/fold_scatter.py::
// fold_count_max_pallas (the Pallas TPU kernel of the counting set, called
// from core/counting_set.py::CountingSet.increment).
//
// For each batch element b with 0 <= slots[b] < cap: count[slot] +=
// amounts[b] and packed[slot, w] = max(packed[slot, w], rows[b, w]) for
// w < W, comparing as unsigned; other slots are dropped. The TPU kernel
// reduced a one-hot [batch tile, table tile] match; here the reduction is
// integer atomics, which is bitwise equal because integer add and unsigned
// max are associative and commutative.
//
// What bounds it on an H100: the bytes, (4 * B * (W + 2) + 4 * cap *
// (W + 1)) / 3.35 TB/s at most, once contention and fixed costs are out of
// the way. DegreeTriples folds millions of triangles into a few hundred
// heavily skewed slots in a pull superstep, and most of its launches (one
// per shard and push superstep) fold 2^9-2^13 triangles, where the fixed
// costs of a launch set the time. The fold body, shared with hist_add and
// hist_max, is fold_common.cuh's (staged rows, match-aggregated counts,
// words max-ed only where they exceed the table; one-block, blocks and
// device-atomic paths); its notes give the design. Here both tables are
// folded (count and max). Measured on the scale-18 cell's folds
// (tools/kernel_ab.py, PERF.md): 0.040 ms at the largest fold (2.5 M
// triangles), against 0.063 ms for a thread an element with a shared
// atomic a word, each block zeroing and flushing all cap slots behind two
// fills; 0.010 against 0.013 ms at the typical fold (1,910 triangles),
// where an empty kernel of the same launch shape takes 0.005 ms and
// zeroing and writing the 96 KB of tables from one SM 0.003 ms. Tried and
// dropped: per-group __reduce_*_sync (0.071 ms); device atomics at every
// size (no faster below 2^9 elements, slower above).
//
// Built by repro_torch/kernels/_cuda.py with nvcc for sm_90a; C interface
// for ctypes. Returns the first CUDA error of the launch, or 0.
#include <cuda_runtime.h>
#include <stdint.h>

#include "fold_common.cuh"

namespace {

// limits measured by tools/kernel_ab.py's path sweep (PERF.md): one block
// up to kFoldSingleMaxB elements, then blocks of at least kFoldPerBlock
// elements each
constexpr long long kFoldSingleMaxB = 16384;
constexpr long long kFoldPerBlock = 16384;

}  // namespace

// table: the caller's [cap * (W + 1)] int32 buffer: count [cap], then
// packed [cap, W]. A table too large for shared memory (beside the row
// stages, which only rows of W <= 14 words get) is cut into slices that
// fit, rows read where they lie; device atomics only where a slice of 32
// slots does not fit (W > 1,814). Device atomics on the hot slots of a
// wide row serialise: 5.47 ms against 0.16 ms on slices at W = 16 on
// DegreeTriples' largest fold's slots (PERF.md).
extern "C" int tripoll_fold_count_max(const void* slots, const void* amounts,
                                      const void* rows, long long B, int W,
                                      int cap, void* table, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (!fold::fits<true, true>(W, cap)) {
    if (!fold::sliceable<true, true>(W))
      return (int)fold::direct<true, true>(slots, amounts, rows, B, W, cap,
                                           table, st);
    return (int)fold::sliced<true, true>(slots, amounts, rows, B, W, cap,
                                         table, kFoldPerBlock, st);
  }
  if (B <= kFoldSingleMaxB)
    return (int)fold::single<true, true>(slots, amounts, rows, B, W, cap,
                                         table, st);
  return (int)fold::blocks<true, true>(slots, amounts, rows, B, W, cap, table,
                                       kFoldPerBlock, st);
}

// ring_set: deterministic last-writer-wins scatter-set of int32 rows into
// a copy of the carried [cap, 3] table.
//
// Replaces src/repro/kernels/fold_scatter/fold_scatter.py::ring_set_pallas
// (the Pallas TPU kernel of Enumerate's ring buffer, called from
// core/surveys.py::Enumerate.update).
//
// For each slot in [0, cap), the row of the highest batch index that
// targets it wins; slots with no writer keep the prior row; slots outside
// [0, cap) are dropped. The TPU kernel took the max batch index over a
// one-hot [batch tile, table tile] match and let later grid steps
// overwrite earlier ones. Here the winner is explicit:
// - pass 1, over the batch: atomicMax of the batch index into win [cap],
//   which the launcher sets to -1 on the stream;
// - pass 2, over the table: out[s] = win[s] >= 0 ? row(win[s]) : prior[s],
//   the plain version's torch.where, one thread per output word.
// The rows are read where they lie, through three column pointers and
// element strides: Enumerate passes its batch's p, q and r columns, so no
// [B, 3] copy is made.
//
// What bounds it on an H100: the 4 * B bytes of slots (402.6 MB in a
// scale-18 pull window, where Enumerate sends almost every lane to the
// dropped slot cap), then the table in and out and the winners' rows, at
// 3.35 TB/s. Pass 1 reads the slots once, as 16-byte streaming loads (a
// scalar head where the view's offset breaks the alignment, a scalar
// tail); a warp whose 128 slots are all out of range skips the atomics
// on a ballot. Pass 2 touches only the table. A first design read the
// slots twice (pass 2 over the batch) behind a clone and a fill: 2.9x the
// bound.

__device__ __forceinline__ void ring_claim(int s, int cap, int b,
                                           int* __restrict__ win) {
  if ((unsigned)s < (unsigned)cap) atomicMax(win + s, b);
}

__global__ void ring_set_winner(const int* __restrict__ slots, long long B,
                                int cap, int* __restrict__ win) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nthreads = (long long)gridDim.x * blockDim.x;
  const int a = (int)(((uintptr_t)slots >> 2) & 3);
  const long long to_quad = (4 - a) & 3;
  const long long head = to_quad < B ? to_quad : B;
  const long long nvec = (B - head) >> 2;
  const long long tail = head + 4 * nvec;
  if (tid < head) ring_claim(slots[tid], cap, (int)tid, win);
  if (tail + tid < B) ring_claim(slots[tail + tid], cap, (int)(tail + tid), win);
  const int4* sv = reinterpret_cast<const int4*>(slots + head);
  // the trip count is the warp's, so the ballot sees every lane
  for (long long q = tid; q - (threadIdx.x & 31) < nvec; q += nthreads) {
    int4 v = make_int4(-1, -1, -1, -1);
    if (q < nvec) v = __ldcs(sv + q);
    const bool any = (unsigned)v.x < (unsigned)cap ||
                     (unsigned)v.y < (unsigned)cap ||
                     (unsigned)v.z < (unsigned)cap ||
                     (unsigned)v.w < (unsigned)cap;
    if (!__any_sync(0xffffffffu, any)) continue;
    const int b = (int)(head + 4 * q);
    ring_claim(v.x, cap, b, win);
    ring_claim(v.y, cap, b + 1, win);
    ring_claim(v.z, cap, b + 2, win);
    ring_claim(v.w, cap, b + 3, win);
  }
}

__global__ void ring_set_gather(const int* __restrict__ win,
                                const int* __restrict__ prior,
                                const int* __restrict__ c0,
                                const int* __restrict__ c1,
                                const int* __restrict__ c2, long long st0,
                                long long st1, long long st2, int cap,
                                int* __restrict__ out) {
  const long long words = 3LL * cap;
  for (long long w = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       w < words; w += (long long)gridDim.x * blockDim.x) {
    const long long s = w / 3;
    const int c = (int)(w - 3 * s);
    const long long b = win[s];
    int v;
    if (b < 0) {
      v = prior[w];
    } else if (c == 0) {
      v = c0[b * st0];
    } else if (c == 1) {
      v = c1[b * st1];
    } else {
      v = c2[b * st2];
    }
    out[w] = v;
  }
}

extern "C" int tripoll_ring_set(const void* slots, long long B, int cap,
                                const void* prior, const void* c0,
                                const void* c1, const void* c2, long long st0,
                                long long st1, long long st2, void* win,
                                void* out, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(win, 0xFF, (size_t)cap * sizeof(int), st);
  if (err != cudaSuccess) return (int)err;
  const int threads = 256;
  const long long full = (long long)sms * (2048 / threads);  // one wave
  long long blocks = ((B + 3) / 4 + threads - 1) / threads;
  ring_set_winner<<<(unsigned)(blocks < full ? blocks : full), threads, 0,
                    st>>>((const int*)slots, B, cap, (int*)win);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  blocks = (3LL * cap + threads - 1) / threads;
  ring_set_gather<<<(unsigned)(blocks < full ? blocks : full), threads, 0,
                    st>>>((const int*)win, (const int*)prior, (const int*)c0,
                          (const int*)c1, (const int*)c2, st0, st1, st2, cap,
                          (int*)out);
  return (int)cudaGetLastError();
}
