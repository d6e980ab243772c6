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
// costs of a launch set the time. Design:
// - Loads in flight. A warp takes kUnroll chunks of 32 consecutive
//   elements at a time: their slots and amounts into registers, their rows
//   (32 * W contiguous words a chunk) into its own shared memory with
//   16-byte cp.async (4-byte where the rows are not 16-byte aligned or the
//   chunk is the ragged last one), all issued before the first is used.
//   Lane l then reads row l there (stride W: no bank conflict for odd W).
// - Few atomics on hot slots. Where the warp's kept lanes share one amount
//   (the counting set's case), __match_any_sync groups the lanes of a slot
//   and the group's lowest lane adds amount * group size: one atomic a
//   slot. A word is max-ed only where it exceeds what the table holds: a
//   hot slot's words settle after its first updates, and later lanes only
//   read them. Zero amounts and zero words never update.
// - Fixed costs that grow with the work. At most FOLD_SINGLE_MAX_B
//   elements: one block reduces into tables in shared memory and then
//   writes them whole: no memset, no device atomics. Above it: the
//   launcher zeroes the tables with cudaMemsetAsync, each block reduces
//   into its own shared tables, and flushes only the slots a bitmap marks
//   as touched, one device atomic a non-zero word; the grid is sized from
//   B. Tables too large for shared memory take device atomics directly.
// Measured on the scale-18 cell's folds (tools/kernel_ab.py, PERF.md):
// 0.040 ms at the largest fold (2.5 M triangles), against 0.063 ms for a
// thread an element with a shared atomic a word, each block zeroing and
// flushing all cap slots behind two fills; 0.010 against 0.013 ms at the
// typical fold (1,910 triangles), where an empty kernel of the same launch
// shape takes 0.005 ms and zeroing and writing the 96 KB of tables from one
// SM 0.003 ms. Tried and dropped: every kept lane in a __match_any_sync
// group with a __reduce_add_sync and W __reduce_max_sync a group (a redux
// over a divergent group mask runs once a group, so a chunk of many slots
// serialises: 0.071 ms); device atomics at every size (no faster below
// 2^9 elements, slower above).
//
// Built by repro_torch/kernels/_cuda.py with nvcc for sm_90a; C interface
// for ctypes. Returns the first CUDA error of the launch, or 0.
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef FOLD_SINGLE_MAX_B
#define FOLD_SINGLE_MAX_B 16384  // crossover measured by tools/kernel_ab.py
#endif
#ifndef FOLD_SMEM_MAX
#define FOLD_SMEM_MAX (227 * 1024)  // shared memory a block may take
#endif

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kFoldThreads = 1024;
constexpr int kFoldWarps = kFoldThreads / 32;
constexpr int kUnroll = 4;             // chunks a warp has in flight
constexpr int kElemsPerBlock = 16384;  // at the least, on the blocks path

enum Path { kSingle, kBlocks, kDirect };

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Start copying the n rows of the chunk at b0 into stage[0, n * W).
__device__ __forceinline__ void stage_rows(const unsigned* __restrict__ rows,
                                           long long b0, int n, int W,
                                           bool vec, unsigned* stage,
                                           int lane) {
  const unsigned* src = rows + b0 * W;
  if (vec && n == 32) {  // 32 * W words from a 16-byte aligned start
    for (int q = lane; q < 8 * W; q += 32) cp_async16(stage + 4 * q, src + 4 * q);
  } else {
    for (int j = lane; j < n * W; j += 32) cp_async4(stage + j, src + j);
  }
}

// Fold one element (slot s, amount a, row) into the tables; every lane of
// the warp calls it. kShared: the tables are the block's in shared memory
// (words are read before they are max-ed, slots marked in touched).
template <bool kShared>
__device__ __forceinline__ void fold_lane(int s, int a,
                                          const unsigned* row, int W,
                                          int cap, int* t_count,
                                          unsigned* t_packed,
                                          unsigned* touched, int lane) {
  const bool valid = (unsigned)s < (unsigned)cap;
  const unsigned vmask = __ballot_sync(kFull, valid);
  if (!valid) return;
  int same = 0;
  __match_all_sync(vmask, a, &same);
  if (same) {
    const unsigned grp = __match_any_sync(vmask, s);
    if (lane == __ffs(grp) - 1 && a != 0)
      atomicAdd((unsigned*)t_count + s, (unsigned)a * __popc(grp));
  } else if (a != 0) {
    atomicAdd(t_count + s, a);
  }
  unsigned* dst = t_packed + (long long)s * W;
  for (int w = 0; w < W; ++w) {
    const unsigned v = row[w];
    if (kShared ? v > dst[w] : v != 0u) atomicMax(dst + w, v);
  }
  if (kShared) {
    const unsigned bit = 1u << (s & 31);
    if (!(touched[s >> 5] & bit)) atomicOr(touched + (s >> 5), bit);
  }
}

// Bytes of shared memory a block of the path takes.
__host__ __device__ inline size_t fold_smem(int path, int W, int cap) {
  const size_t stages = (size_t)kFoldWarps * kUnroll * 32 * W * 4;
  if (path == kDirect) return stages;
  return stages + ((size_t)cap * (W + 1) + (cap + 31) / 32) * 4;
}

template <int kPath>
__global__ void __launch_bounds__(kFoldThreads)
    fold_count_max_kernel(const int* __restrict__ slots,
                          const int* __restrict__ amounts,
                          const unsigned* __restrict__ rows, long long B,
                          int W, int cap, int* __restrict__ table) {
  extern __shared__ __align__(16) unsigned smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // the warp's kUnroll stages, then (shared paths) the count table, the
  // packed table and the touched bitmap
  unsigned* stage = smem + warp * kUnroll * 32 * W;
  constexpr bool kShared = kPath != kDirect;
  int* t_count = table;
  unsigned* t_packed = (unsigned*)table + cap;
  unsigned* touched = nullptr;
  const int words = cap * (W + 1);
  if (kShared) {
    unsigned* tab = smem + kFoldWarps * kUnroll * 32 * W;
    t_count = (int*)tab;
    t_packed = tab + cap;
    touched = tab + words;
    const int all = words + (cap + 31) / 32;
    uint4* t4 = reinterpret_cast<uint4*>(tab);  // 16-byte aligned
    for (int i = threadIdx.x; i < all / 4; i += blockDim.x)
      t4[i] = make_uint4(0u, 0u, 0u, 0u);
    for (int i = 4 * (all / 4) + threadIdx.x; i < all; i += blockDim.x)
      tab[i] = 0u;
    __syncthreads();
  }
  const bool vec = ((uintptr_t)rows & 15) == 0;
  const long long chunks = (B + 31) >> 5;
  const long long stride = (long long)gridDim.x * kFoldWarps;
  for (long long c0 = (long long)blockIdx.x * kFoldWarps + warp; c0 < chunks;
       c0 += kUnroll * stride) {
    int s[kUnroll], a[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long b0 = (c0 + u * stride) << 5;
      const int n = b0 < B ? (int)(B - b0 < 32 ? B - b0 : 32) : 0;
      s[u] = -1;
      a[u] = 0;
      if (lane < n) {
        s[u] = slots[b0 + lane];
        a[u] = amounts[b0 + lane];
      }
      if (n > 0) stage_rows(rows, b0, n, W, vec, stage + u * 32 * W, lane);
    }
    cp_async_wait_all();
    __syncwarp();
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      fold_lane<kShared>(s[u], a[u], stage + u * 32 * W + lane * W, W, cap,
                         t_count, t_packed, touched, lane);
    __syncwarp();  // the stages are refilled by the next round
  }
  if (kPath == kSingle) {  // the block's tables are the result
    __syncthreads();
    const uint4* s4 = reinterpret_cast<const uint4*>(t_count);
    uint4* d4 = reinterpret_cast<uint4*>(table);
    for (int i = threadIdx.x; i < words / 4; i += blockDim.x) d4[i] = s4[i];
    for (int i = 4 * (words / 4) + threadIdx.x; i < words; i += blockDim.x)
      table[i] = t_count[i];
  } else if (kPath == kBlocks) {  // flush the touched slots
    __syncthreads();
    for (int i = threadIdx.x; i < cap; i += blockDim.x) {
      if (!(touched[i >> 5] & (1u << (i & 31)))) continue;
      const int c = t_count[i];
      if (c != 0) atomicAdd(table + i, c);
      for (int w = 0; w < W; ++w) {
        const unsigned v = t_packed[i * W + w];
        if (v != 0u)
          atomicMax((unsigned*)table + cap + (long long)i * W + w, v);
      }
    }
  }
}

template <int kPath>
cudaError_t launch(const void* slots, const void* amounts, const void* rows,
                   long long B, int W, int cap, void* table, long long blocks,
                   size_t smem, cudaStream_t st) {
  static size_t allowed = 48 * 1024;  // the most this kernel may take
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        fold_count_max_kernel<kPath>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  fold_count_max_kernel<kPath><<<(unsigned)blocks, kFoldThreads, smem, st>>>(
      (const int*)slots, (const int*)amounts, (const unsigned*)rows, B, W,
      cap, (int*)table);
  return cudaGetLastError();
}

}  // namespace

// table: the caller's [cap * (W + 1)] int32 buffer: count [cap], then
// packed [cap, W].
extern "C" int tripoll_fold_count_max(const void* slots, const void* amounts,
                                      const void* rows, long long B, int W,
                                      int cap, void* table, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t bytes = (size_t)cap * (W + 1) * 4;
  const size_t smem = fold_smem(kBlocks, W, cap);
  if (B > 0 && B <= FOLD_SINGLE_MAX_B && smem <= FOLD_SMEM_MAX)
    return (int)launch<kSingle>(slots, amounts, rows, B, W, cap, table, 1,
                                smem, st);
  cudaError_t err = cudaMemsetAsync(table, 0, bytes, st);
  if (err != cudaSuccess || B == 0) return (int)err;
  int device = 0, sms = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return (int)err;
  if (smem <= FOLD_SMEM_MAX) {  // one block an SM
    const long long blocks = (B + kElemsPerBlock - 1) / kElemsPerBlock;
    return (int)launch<kBlocks>(slots, amounts, rows, B, W, cap, table,
                                blocks < sms ? blocks : sms, smem, st);
  }
  const size_t dsmem = fold_smem(kDirect, W, cap);
  if (dsmem > 227 * 1024) return (int)cudaErrorInvalidValue;
  const long long per_block = (long long)kFoldThreads * kUnroll;
  const long long blocks = (B + per_block - 1) / per_block;
  return (int)launch<kDirect>(slots, amounts, rows, B, W, cap, table,
                              blocks < 2LL * sms ? blocks : 2LL * sms, dsmem,
                              st);
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
