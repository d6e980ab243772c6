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
// integer atomics, which is bitwise equal because integer add and max
// commute. Zero amounts and zero words are skipped: they are the
// identities of add and unsigned max.
//
// What bounds it on an H100: contention. DegreeTriples folds millions of
// triangles into a few hundred distinct slots, and atomics on one address
// serialise in L2. So each block first reduces its share of the batch
// into a block-private copy of the tables in shared memory (cap * (W + 1)
// words: 96 KB at cap = 4096, W = 5), then flushes the slots it touched to
// device memory with one atomic per non-identity word. Tables too large
// for shared memory take the direct path: one thread per element, global
// atomics. The least time for the bytes is (4 * B * (W + 2) + 4 * cap *
// (W + 1)) / 3.35 TB/s.
//
// The tables come in zeroed: the wrapper allocates fresh tables and the
// counting set combines them with its state, as the reference does.
//
// Built by repro_torch/kernels/_cuda.py with nvcc for sm_90a; C interface
// for ctypes. Returns cudaGetLastError() of the launch.
#include <cuda_runtime.h>

__global__ void fold_count_max_global(const int* __restrict__ slots,
                                      const int* __restrict__ amounts,
                                      const unsigned* __restrict__ rows,
                                      long long B, int W, int cap,
                                      int* __restrict__ count,
                                      unsigned* __restrict__ packed) {
  for (long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x; b < B;
       b += (long long)gridDim.x * blockDim.x) {
    const int s = slots[b];
    if (s < 0 || s >= cap) continue;
    const int a = amounts[b];
    if (a != 0) atomicAdd(count + s, a);
    const unsigned* row = rows + b * (long long)W;
    unsigned* dst = packed + (long long)s * W;
    for (int w = 0; w < W; ++w) {
      const unsigned v = row[w];
      if (v != 0u) atomicMax(dst + w, v);
    }
  }
}

__global__ void fold_count_max_shared(const int* __restrict__ slots,
                                      const int* __restrict__ amounts,
                                      const unsigned* __restrict__ rows,
                                      long long B, int W, int cap,
                                      int* __restrict__ count,
                                      unsigned* __restrict__ packed) {
  extern __shared__ unsigned smem[];
  int* s_count = (int*)smem;
  unsigned* s_packed = smem + cap;
  const int words = cap * (W + 1);
  for (int i = threadIdx.x; i < words; i += blockDim.x) smem[i] = 0u;
  __syncthreads();
  for (long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x; b < B;
       b += (long long)gridDim.x * blockDim.x) {
    const int s = slots[b];
    if (s < 0 || s >= cap) continue;
    const int a = amounts[b];
    if (a != 0) atomicAdd(s_count + s, a);
    const unsigned* row = rows + b * (long long)W;
    unsigned* dst = s_packed + s * W;
    for (int w = 0; w < W; ++w) {
      const unsigned v = row[w];
      if (v != 0u) atomicMax(dst + w, v);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < cap; i += blockDim.x) {
    const int c = s_count[i];
    if (c != 0) atomicAdd(count + i, c);
    for (int w = 0; w < W; ++w) {
      const unsigned v = s_packed[i * W + w];
      if (v != 0u) atomicMax(packed + (long long)i * W + w, v);
    }
  }
}

extern "C" int tripoll_fold_count_max(const void* slots, const void* amounts,
                                      const void* rows, long long B, int W,
                                      int cap, void* count, void* packed,
                                      void* stream) {
  const int threads = 512;
  long long blocks = (B + threads - 1) / threads;
  const size_t smem = (size_t)cap * (W + 1) * sizeof(unsigned);
  const size_t smem_max = 227 * 1024;
  if (smem <= smem_max) {
    int device = 0, sms = 132;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    const long long per_sm = smem > 0 ? (long long)(smem_max / smem) : 1;
    const long long max_blocks = (long long)sms * (per_sm > 4 ? 4 : per_sm);
    if (blocks > max_blocks) blocks = max_blocks;
    cudaFuncSetAttribute(fold_count_max_shared,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    fold_count_max_shared<<<(unsigned)blocks, threads, smem,
                            (cudaStream_t)stream>>>(
        (const int*)slots, (const int*)amounts, (const unsigned*)rows, B, W,
        cap, (int*)count, (unsigned*)packed);
  } else {
    const long long max_blocks = 132LL * 32;
    if (blocks > max_blocks) blocks = max_blocks;
    fold_count_max_global<<<(unsigned)blocks, threads, 0,
                            (cudaStream_t)stream>>>(
        (const int*)slots, (const int*)amounts, (const unsigned*)rows, B, W,
        cap, (int*)count, (unsigned*)packed);
  }
  return (int)cudaGetLastError();
}

// ring_set: deterministic last-writer-wins scatter-set of [B, 3] int32 rows
// into a copy of the carried [cap, 3] table.
//
// Replaces src/repro/kernels/fold_scatter/fold_scatter.py::ring_set_pallas
// (the Pallas TPU kernel of Enumerate's ring buffer, called from
// core/surveys.py::Enumerate.update).
//
// For each slot in [0, cap), the row of the highest batch index that
// targets it wins; slots with no writer keep the prior row; slots outside
// [0, cap) are dropped. The TPU kernel took the max batch index over a
// one-hot [batch tile, table tile] match and let later grid steps
// overwrite earlier ones. Here pass 1 takes atomicMax of the batch index
// into a [cap] table initialised to -1 (by the wrapper), and pass 2 lets
// the one element whose index equals its slot's winner write its row into
// the output, which the wrapper filled with the prior table. Batch indices
// are unique, so each slot has at most one writer in pass 2 and the result
// is deterministic.
//
// What bounds it on an H100: the bytes of the batch — 4 * B slots read
// twice (once a pass) and 12 bytes of row for each winner — at 3.35 TB/s.
// Enumerate routes its invalid lanes (most of a pull window) to slot cap,
// so they cost one coalesced read a pass and nothing else.

__global__ void ring_set_winner(const int* __restrict__ slots, long long B,
                                int cap, int* __restrict__ win) {
  for (long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x; b < B;
       b += (long long)gridDim.x * blockDim.x) {
    const int s = slots[b];
    if (s >= 0 && s < cap) atomicMax(win + s, (int)b);
  }
}

__global__ void ring_set_write(const int* __restrict__ slots,
                               const int* __restrict__ rows, long long B,
                               int cap, const int* __restrict__ win,
                               int* __restrict__ out) {
  for (long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x; b < B;
       b += (long long)gridDim.x * blockDim.x) {
    const int s = slots[b];
    if (s < 0 || s >= cap || win[s] != (int)b) continue;
    const int* row = rows + 3 * b;
    int* dst = out + 3 * (long long)s;
    dst[0] = row[0];
    dst[1] = row[1];
    dst[2] = row[2];
  }
}

extern "C" int tripoll_ring_set(const void* slots, const void* rows,
                                long long B, int cap, void* win, void* out,
                                void* stream) {
  const int threads = 512;
  long long blocks = (B + threads - 1) / threads;
  const long long max_blocks = 132LL * 32;
  if (blocks > max_blocks) blocks = max_blocks;
  ring_set_winner<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)slots, B, cap, (int*)win);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ring_set_write<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)slots, (const int*)rows, B, cap, (const int*)win,
      (int*)out);
  return (int)cudaGetLastError();
}
