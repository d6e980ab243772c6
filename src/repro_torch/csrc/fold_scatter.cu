// fold_count_max: one pass of count scatter-add and packed-row scatter-max.
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
