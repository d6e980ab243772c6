// hist_add and hist_max: scatter-add of int32 amounts and row-wise unsigned
// scatter-max of uint32 rows, each into a fresh zeroed table.
//
// Replace src/repro/kernels/hist/hist.py::hist_add_pallas and
// hist_max_pallas (the Pallas TPU kernels of the unfused counting-set
// update). In the port, hist_add also folds the dense-histogram surveys
// (LocalVertexCount, ClosureTime, MaxEdgeLabelDist) and the pair carries
// CountingSet's "scatter" backend (LabelTripleSet on the bundle path).
//
// hist_add: for each b with 0 <= slots[b] < cap, count[slot] += amounts[b]
// (int32, wrapping). hist_max: for each b with 0 <= slots[b] < cap and
// w < W, packed[slot, w] = max(packed[slot, w], rows[b, w]) as unsigned.
// Other slots are dropped, as the TPU kernels' one-hot drops them. The TPU
// kernels reduced a one-hot [batch tile, table tile] match; here the
// reduction is integer atomics, bitwise equal because integer add and
// unsigned max commute. Zero amounts and zero words are skipped: they are
// the identities of add and unsigned max.
//
// What bounds them on an H100: the bytes of the batch and the table at
// 3.35 TB/s, once contention and fixed costs are out of the way. Their
// callers fold one survey's valid triangles a superstep: tables of 16
// slots (MaxEdgeLabelDist), 4,096 (ClosureTime, LabelTripleSet's count and
// its [4,096, 5] rows) and 262,144 (LocalVertexCount, 1 MiB: more than
// shared memory, three ids a triangle, hub ids hot). Most folds hold 2^9 to
// 2^16 triangles, where a launch's fixed costs set the time, and every
// kept amount is 1.
//
// Each batch size takes the faster of two designs, as tools/kernel_ab.py
// measures them on each caller's calls (PERF.md):
// - fold_common.cuh's fold body, fold_count_max's, counting only
//   (hist_add: no rows staged, no match aggregation in shared tables) or
//   maxing only (hist_max): one block that writes the whole table for
//   batches of at most 4,096 elements, no memset; blocks an SM for large
//   count folds; LocalVertexCount's table by match-aggregated device
//   atomics, then (past 2^22 ids) by blocks on slices of the table, where
//   hub ids would serialise at one L2 address.
// - the first port's kernels, kept where they stay faster: a thread an
//   element with one atomic a word, into block-private shared tables of
//   512-thread blocks, up to 4 an SM (mid-sized folds of the 16- and
//   4,096-slot tables, and hist_max past one block), or, for hist_max
//   tables too large for shared memory or rows too wide to stage, straight
//   into the zeroed table.
//
// Built by repro_torch/kernels/_cuda.py with nvcc for sm_90a; C interface
// for ctypes. Each entry point returns the first CUDA error, or 0.
#include <cuda_runtime.h>

#include "fold_common.cuh"

namespace {

// limits measured by tools/kernel_ab.py's path sweeps (PERF.md). hist_add
// into a table that fits in shared memory: one block up to kAddSingleMaxB
// elements, the first port's shared kernel up to kAddKeptMaxB, then blocks
// of at least kAddPerBlock elements; into a larger table: device atomics
// up to kAddDirectMaxB elements, then blocks on slices of the table.
// hist_max: one block up to kMaxSingleMaxB elements, then the first port's
// kernels.
constexpr long long kAddSingleMaxB = 4096;
constexpr long long kAddKeptMaxB = 524288;
constexpr long long kAddDirectMaxB = 4194304;
constexpr long long kAddPerBlock = 2048;
constexpr long long kMaxSingleMaxB = 4096;

// ---------------------------------------------------------------------------
// the first port's kernels, for the batch sizes where they stay faster

constexpr int kKeptThreads = 512;

__global__ void hist_add_shared(const int* __restrict__ slots,
                                const int* __restrict__ amounts, long long B,
                                int cap, int* __restrict__ count) {
  extern __shared__ int s_count[];
  for (int i = threadIdx.x; i < cap; i += blockDim.x) s_count[i] = 0;
  __syncthreads();
  for (long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x; b < B;
       b += (long long)gridDim.x * blockDim.x) {
    const int s = slots[b];
    if (s < 0 || s >= cap) continue;
    const int a = amounts[b];
    if (a != 0) atomicAdd(s_count + s, a);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cap; i += blockDim.x) {
    const int c = s_count[i];
    if (c != 0) atomicAdd(count + i, c);
  }
}

// kShared: into block-private tables in shared memory, flushed with one
// device atomic a non-zero word; else straight into the zeroed table.
template <bool kShared>
__global__ void hist_max_kept(const int* __restrict__ slots,
                              const unsigned* __restrict__ rows, long long B,
                              int W, int cap, unsigned* __restrict__ packed) {
  extern __shared__ unsigned s_packed[];
  const int words = cap * W;
  unsigned* table = kShared ? s_packed : packed;
  if (kShared) {
    for (int i = threadIdx.x; i < words; i += blockDim.x) s_packed[i] = 0u;
    __syncthreads();
  }
  for (long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x; b < B;
       b += (long long)gridDim.x * blockDim.x) {
    const int s = slots[b];
    if (s < 0 || s >= cap) continue;
    const unsigned* row = rows + b * (long long)W;
    unsigned* dst = table + (long long)s * W;
    for (int w = 0; w < W; ++w) {
      const unsigned v = row[w];
      if (v != 0u) atomicMax(dst + w, v);
    }
  }
  if (kShared) {
    __syncthreads();
    for (int i = threadIdx.x; i < words; i += blockDim.x) {
      const unsigned v = s_packed[i];
      if (v != 0u) atomicMax(packed + i, v);
    }
  }
}

// Zero the table of `bytes`, then launch kernel over B elements in the
// first port's launch shape: 512-thread blocks; with smem bytes of shared
// memory a block, at most 4 an SM (fewer where the table leaves room for
// fewer), else at most 32 an SM.
template <typename Kernel, typename... Args>
cudaError_t kept(Kernel kernel, void* table, size_t bytes, long long B,
                 size_t smem, cudaStream_t st, Args... args) {
  cudaError_t err = cudaMemsetAsync(table, 0, bytes, st);
  if (err != cudaSuccess || B == 0) return err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  long long per_sm = 32;
  if (smem > 0) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    per_sm = (long long)(fold::kSmemBlock / smem);
    per_sm = per_sm < 4 ? per_sm : 4;
  }
  long long blocks = (B + kKeptThreads - 1) / kKeptThreads;
  blocks = blocks < sms * per_sm ? blocks : sms * per_sm;
  kernel<<<(unsigned)blocks, kKeptThreads, smem, st>>>(args...);
  return cudaGetLastError();
}

}  // namespace

// count: the caller's [cap] int32 buffer; the launcher zeroes it where the
// path needs it.
extern "C" int tripoll_hist_add(const void* slots, const void* amounts,
                                long long B, int cap, void* count,
                                void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (!fold::fits<true, false>(0, cap)) {
    if (B <= kAddDirectMaxB)
      return (int)fold::direct<true, false>(slots, amounts, nullptr, B, 0,
                                            cap, count, st);
    return (int)fold::sliced<true, false>(slots, amounts, nullptr, B, 0, cap,
                                          count, kAddPerBlock, st);
  }
  if (B <= kAddSingleMaxB)
    return (int)fold::single<true, false>(slots, amounts, nullptr, B, 0, cap,
                                          count, st);
  if (B <= kAddKeptMaxB) {
    const size_t bytes = (size_t)cap * 4;
    return (int)kept(hist_add_shared, count, bytes, B, bytes, st,
                     (const int*)slots, (const int*)amounts, B, cap,
                     (int*)count);
  }
  return (int)fold::blocks<true, false>(slots, amounts, nullptr, B, 0, cap,
                                        count, kAddPerBlock, st);
}

// packed: the caller's [cap, W] buffer of uint32 words; the launcher zeroes
// it where the path needs it.
extern "C" int tripoll_hist_max(const void* slots, const void* rows,
                                long long B, int W, int cap, void* packed,
                                void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (B <= kMaxSingleMaxB && fold::staged<true>(W) &&
      fold::fits<false, true>(W, cap))
    return (int)fold::single<false, true>(slots, nullptr, rows, B, W, cap,
                                          packed, st);
  const size_t bytes = (size_t)cap * W * 4;
  if (bytes <= fold::kSmemBlock)
    return (int)kept(hist_max_kept<true>, packed, bytes, B, bytes, st,
                     (const int*)slots, (const unsigned*)rows, B, W, cap,
                     (unsigned*)packed);
  return (int)kept(hist_max_kept<false>, packed, bytes, B, 0, st,
                   (const int*)slots, (const unsigned*)rows, B, W, cap,
                   (unsigned*)packed);
}
