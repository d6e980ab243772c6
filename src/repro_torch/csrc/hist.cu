// hist_add and hist_max: scatter-add of int32 amounts and row-wise unsigned
// scatter-max of uint32 rows, each into a fresh zeroed table.
//
// Replace src/repro/kernels/hist/hist.py::hist_add_pallas and
// hist_max_pallas (the Pallas TPU kernels of the unfused counting-set
// update). In the port, hist_add also folds the dense-histogram surveys
// (LocalVertexCount, ClosureTime, MaxEdgeLabelDist) and the pair carries
// CountingSet's "scatter" backend.
//
// hist_add: for each b with 0 <= slots[b] < cap, count[slot] += amounts[b].
// hist_max: for each b with 0 <= slots[b] < cap and w < W,
// packed[slot, w] = max(packed[slot, w], rows[b, w]) as unsigned.
// Other slots are dropped, as the TPU kernels' one-hot drops them. The TPU
// kernels reduced a one-hot [batch tile, table tile] match; here the
// reduction is integer atomics, bitwise equal because integer add and max
// commute. Zero amounts and zero words are skipped: they are the
// identities of add and unsigned max.
//
// What bounds them on an H100: the bytes of the batch (4 * B, plus
// 4 * B * W rows or 4 * B amounts) at 3.35 TB/s, and contention where many
// elements hit few slots (ClosureTime's 4,096 bins, MaxEdgeLabelDist's
// 16). So a table that fits in shared memory is reduced block-privately
// and flushed once per block, as fold_scatter.cu does; larger tables
// (LocalVertexCount's one counter per vertex) take global atomics, where
// contention is low because the slots are many.
//
// Built by repro_torch/kernels/_cuda.py with nvcc for sm_90a; C interface
// for ctypes. Each entry point returns cudaGetLastError() of its launch.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr size_t kSmemMax = 227 * 1024;

// the grid of a block-private pass: at most 4 blocks an SM, fewer when
// the table leaves room for fewer
long long private_blocks(long long B, size_t smem) {
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long per_sm = smem > 0 ? (long long)(kSmemMax / smem) : 4;
  const long long max_blocks = (long long)sms * (per_sm > 4 ? 4 : per_sm);
  const long long blocks = (B + kThreads - 1) / kThreads;
  return blocks < max_blocks ? blocks : max_blocks;
}

long long global_blocks(long long B) {
  const long long blocks = (B + kThreads - 1) / kThreads;
  const long long max_blocks = 132LL * 32;
  return blocks < max_blocks ? blocks : max_blocks;
}

}  // namespace

__global__ void hist_add_global(const int* __restrict__ slots,
                                const int* __restrict__ amounts, long long B,
                                int cap, int* __restrict__ count) {
  for (long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x; b < B;
       b += (long long)gridDim.x * blockDim.x) {
    const int s = slots[b];
    if (s < 0 || s >= cap) continue;
    const int a = amounts[b];
    if (a != 0) atomicAdd(count + s, a);
  }
}

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

__global__ void hist_max_global(const int* __restrict__ slots,
                                const unsigned* __restrict__ rows,
                                long long B, int W, int cap,
                                unsigned* __restrict__ packed) {
  for (long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x; b < B;
       b += (long long)gridDim.x * blockDim.x) {
    const int s = slots[b];
    if (s < 0 || s >= cap) continue;
    const unsigned* row = rows + b * (long long)W;
    unsigned* dst = packed + (long long)s * W;
    for (int w = 0; w < W; ++w) {
      const unsigned v = row[w];
      if (v != 0u) atomicMax(dst + w, v);
    }
  }
}

__global__ void hist_max_shared(const int* __restrict__ slots,
                                const unsigned* __restrict__ rows,
                                long long B, int W, int cap,
                                unsigned* __restrict__ packed) {
  extern __shared__ unsigned s_packed[];
  const int words = cap * W;
  for (int i = threadIdx.x; i < words; i += blockDim.x) s_packed[i] = 0u;
  __syncthreads();
  for (long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x; b < B;
       b += (long long)gridDim.x * blockDim.x) {
    const int s = slots[b];
    if (s < 0 || s >= cap) continue;
    const unsigned* row = rows + b * (long long)W;
    unsigned* dst = s_packed + s * W;
    for (int w = 0; w < W; ++w) {
      const unsigned v = row[w];
      if (v != 0u) atomicMax(dst + w, v);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < words; i += blockDim.x) {
    const unsigned v = s_packed[i];
    if (v != 0u) atomicMax(packed + i, v);
  }
}

extern "C" int tripoll_hist_add(const void* slots, const void* amounts,
                                long long B, int cap, void* count,
                                void* stream) {
  const size_t smem = (size_t)cap * sizeof(int);
  if (smem <= kSmemMax) {
    cudaFuncSetAttribute(hist_add_shared,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    hist_add_shared<<<(unsigned)private_blocks(B, smem), kThreads, smem,
                      (cudaStream_t)stream>>>(
        (const int*)slots, (const int*)amounts, B, cap, (int*)count);
  } else {
    hist_add_global<<<(unsigned)global_blocks(B), kThreads, 0,
                      (cudaStream_t)stream>>>(
        (const int*)slots, (const int*)amounts, B, cap, (int*)count);
  }
  return (int)cudaGetLastError();
}

extern "C" int tripoll_hist_max(const void* slots, const void* rows,
                                long long B, int W, int cap, void* packed,
                                void* stream) {
  const size_t smem = (size_t)cap * W * sizeof(unsigned);
  if (smem <= kSmemMax) {
    cudaFuncSetAttribute(hist_max_shared,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
    hist_max_shared<<<(unsigned)private_blocks(B, smem), kThreads, smem,
                      (cudaStream_t)stream>>>(
        (const int*)slots, (const unsigned*)rows, B, W, cap,
        (unsigned*)packed);
  } else {
    hist_max_global<<<(unsigned)global_blocks(B), kThreads, 0,
                      (cudaStream_t)stream>>>(
        (const int*)slots, (const unsigned*)rows, B, W, cap,
        (unsigned*)packed);
  }
  return (int)cudaGetLastError();
}
