// The fold body shared by fold_count_max (fold_scatter.cu), hist_add and
// hist_max (hist.cu): for each batch element b with 0 <= slots[b] < cap,
// count[slot] += amounts[b] (kCount) and packed[slot, w] =
// max(packed[slot, w], rows[b, w]) for w < W, comparing as unsigned
// (kMax); other slots are dropped. The output is one int32 buffer: count
// [cap] (kCount), then packed [cap, W] (kMax). Integer add and unsigned max
// are associative and commutative, so the result is bitwise that of any
// order of the updates.
//
// Design (measured on the scale-18 cell's folds by tools/kernel_ab.py;
// PERF.md):
// - Loads in flight. A warp takes kUnroll chunks of 32 consecutive
//   elements at a time: their slots and amounts into registers, their rows
//   (kMax: 32 * W contiguous words a chunk) into its own shared memory
//   with 16-byte cp.async (4-byte where the rows are not 16-byte aligned or
//   the chunk is the ragged last one), all issued before the first is used.
//   Lane l then reads row l there (stride W: no bank conflict for odd W).
//   Rows are staged only where the block's table fits beside the stages
//   (single() and blocks(), W <= 14: wider rows would need more than a
//   block's 227 KB for the 32 warps' stages alone, 16,384 * W bytes).
//   Elsewhere (sliced(), direct()) lane l reads row l where it lies in
//   device memory, and no stage is allocated.
// - Few atomics on hot slots. Where the warp's kept lanes share one amount
//   (every caller's case: the amounts are 1), __match_any_sync groups the
//   lanes of a slot and the group's lowest lane adds amount * group size:
//   one atomic a slot (on device atomics always; into shared tables only
//   where rows are folded too, as fold_count_max folds them: there the
//   match pays, while hist_add's bare counts are cheaper as one shared
//   atomic a lane). A word is max-ed only where it exceeds what the shared
//   table holds: a hot slot's words settle after its first updates, and
//   later lanes only read them. Zero amounts and zero words never update.
// - Fixed costs that grow with the work: four paths, which each launcher
//   picks by batch size at the limits tools/kernel_ab.py measured for it.
//   single(): one block reduces into tables in shared memory and then
//   writes them whole: no memset, no device atomics. The others zero the
//   output with cudaMemsetAsync first. direct(): match-aggregated device
//   atomics straight into it. blocks(): blocks (as many an SM as shared
//   memory and threads allow, at least `per_block` elements each) reduce
//   into their own shared tables and flush with one device atomic a
//   non-zero word (where rows are folded, only the slots a bitmap marks as
//   touched). sliced(): blocks() for a table too large for one block's
//   shared memory (LocalVertexCount's 1 MiB), cut into slices that do fit:
//   each block folds one slice's elements of its share of the batch, so
//   the batch is read once a slice, and hub ids contend in shared memory
//   instead of at one L2 address.
// Tried and dropped (PERF.md): every kept lane in a __match_any_sync group
// with a __reduce_add_sync and W __reduce_max_sync a group (a redux over a
// divergent group mask runs once a group, so a chunk of many slots
// serialises); several copies of a count table a block; a DSMEM cluster
// holding LocalVertexCount's table.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Everything here has internal linkage: each source that includes it is
// its own shared library, and a function-local static of an exported
// template (launch_path's) would be one object across every library of the
// process that instantiates it.
namespace fold {
namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;             // chunks a warp has in flight
constexpr int kDirectElemsPerBlock = 512;  // at the least, device atomics
constexpr size_t kSmemBlock = 227 * 1024;  // the most a block can take

enum Path { kSingle, kBlocks, kSliced, kDirect };

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

// Bytes of the 32 warps' row stages, and whether they fit in one block's
// shared memory by themselves (W <= 14): wider rows are never staged.
__host__ __device__ inline size_t stage_bytes(int W) {
  return (size_t)kWarps * kUnroll * 32 * W * 4;
}

template <bool kMax>
__host__ __device__ inline bool staged(int W) {
  return kMax && stage_bytes(W) <= kSmemBlock;
}

// Fold one element (slot s, amount a, row) into the tables; every lane of
// the warp calls it. kShared: the tables are the block's in shared memory
// (words are read before they are max-ed; where rows are folded, slots are
// marked in touched, so that the flush reads one bit, not W + 1 words, of
// an untouched slot).
template <bool kShared, bool kCount, bool kMax>
__device__ __forceinline__ void fold_lane(int s, int a,
                                          const unsigned* row, int W,
                                          int cap, int* t_count,
                                          unsigned* t_packed,
                                          unsigned* touched, int lane) {
  // match-aggregated counts: on device atomics, and in shared tables
  // where rows are folded too (the notes above)
  constexpr bool kMatch = kCount && (!kShared || kMax);
  const bool valid = (unsigned)s < (unsigned)cap;
  const unsigned vmask = kMatch ? __ballot_sync(kFull, valid) : 0u;
  if (!valid) return;
  if (kCount && !kMatch) {
    if (a != 0) atomicAdd(t_count + s, a);
  } else if (kCount) {
    int same = 0;
    __match_all_sync(vmask, a, &same);
    if (same) {
      const unsigned grp = __match_any_sync(vmask, s);
      if (lane == __ffs(grp) - 1 && a != 0)
        atomicAdd((unsigned*)t_count + s, (unsigned)a * __popc(grp));
    } else if (a != 0) {
      atomicAdd(t_count + s, a);
    }
  }
  if (kMax) {
    unsigned* dst = t_packed + (long long)s * W;
    for (int w = 0; w < W; ++w) {
      const unsigned v = row[w];
      if (kShared ? v > dst[w] : v != 0u) atomicMax(dst + w, v);
    }
  }
  if (kShared && kMax) {
    const unsigned bit = 1u << (s & 31);
    if (!(touched[s >> 5] & bit)) atomicOr(touched + (s >> 5), bit);
  }
}

// Words of a table of cap slots, and bytes of shared memory a block of
// the path takes for a table of cap slots.
template <bool kCount, bool kMax>
__host__ __device__ inline long long table_words(int W, int cap) {
  return (long long)cap * ((kCount ? 1 : 0) + (kMax ? W : 0));
}

// the touched bitmap's words (only where rows are folded)
template <bool kMax>
__host__ __device__ inline int bitmap_words(int cap) {
  return kMax ? (cap + 31) / 32 : 0;
}

// (rows staged on single() and blocks() only, as launch_path stages them)
template <bool kCount, bool kMax>
__host__ __device__ inline size_t fold_smem(int path, int W, int cap) {
  if (path == kDirect) return 0;
  const size_t stages =
      path != kSliced && staged<kMax>(W) ? stage_bytes(W) : 0;
  return stages + ((size_t)table_words<kCount, kMax>(W, cap) +
                   bitmap_words<kMax>(cap)) * 4;
}

// One pass of the fold. kSingle: one block, its shared tables written out
// whole. kBlocks: each block folds its chunks of the batch into shared
// tables, then flushes the slots it touched with device atomics. kSliced:
// kBlocks for a table cut into slices of `slice` slots; block b folds the
// slots of slice b % n_slices among the chunks of replica b / n_slices.
// kDirect: device atomics on the caller's zeroed table. kStage: rows are
// staged in shared memory (launch_path says where); otherwise each lane
// reads its row in device memory.
template <int kPath, bool kCount, bool kMax, bool kStage>
__global__ void __launch_bounds__(kThreads)
    fold_kernel(const int* __restrict__ slots,
                const int* __restrict__ amounts,
                const unsigned* __restrict__ rows, long long B, int W,
                int cap, int slice, int* __restrict__ table) {
  extern __shared__ __align__(16) unsigned smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int Ws = kMax && kStage ? W : 0;  // words staged a row
  // the warp's kUnroll stages (kMax), then (shared paths) the count table,
  // the packed table and the touched bitmap of the block's slice
  unsigned* stage = smem + warp * kUnroll * 32 * Ws;
  constexpr bool kShared = kPath != kDirect;
  if (kPath != kSliced) slice = cap;
  const int n_slices = kPath == kSliced ? (cap + slice - 1) / slice : 1;
  const int k = blockIdx.x % n_slices;  // the block's slice
  const int lo = k * slice;             // its first slot
  const int n = cap - lo < slice ? cap - lo : slice;  // its slots
  const int c_words = kCount ? cap : 0;
  int* t_count = table;
  unsigned* t_packed = (unsigned*)table + c_words;
  unsigned* touched = nullptr;
  const int words = (int)table_words<kCount, kMax>(W, slice);
  unsigned* tab = smem + kWarps * kUnroll * 32 * Ws;
  if (kShared) {
    t_count = (int*)tab;
    t_packed = tab + (kCount ? slice : 0);
    touched = tab + words;
    const int all = words + bitmap_words<kMax>(slice);
    uint4* t4 = reinterpret_cast<uint4*>(tab);  // 16-byte aligned
    for (int i = threadIdx.x; i < all / 4; i += blockDim.x)
      t4[i] = make_uint4(0u, 0u, 0u, 0u);
    for (int i = 4 * (all / 4) + threadIdx.x; i < all; i += blockDim.x)
      tab[i] = 0u;
    __syncthreads();
  }
  const bool vec = kMax && kStage && ((uintptr_t)rows & 15) == 0;
  const long long chunks = (B + 31) >> 5;
  const long long stride = (long long)(gridDim.x / n_slices) * kWarps;
  for (long long c0 = (long long)(blockIdx.x / n_slices) * kWarps + warp;
       c0 < chunks; c0 += kUnroll * stride) {
    int s[kUnroll], a[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long b0 = (c0 + u * stride) << 5;
      const int m = b0 < B ? (int)(B - b0 < 32 ? B - b0 : 32) : 0;
      s[u] = -1;
      a[u] = 0;
      if (lane < m) {
        s[u] = slots[b0 + lane];
        // -1 and slots past the slice stay out of [0, n) after the shift
        if (kPath == kSliced) s[u] = (int)((unsigned)s[u] - (unsigned)lo);
        if (kCount) a[u] = amounts[b0 + lane];
      }
      if (kMax && kStage && m > 0)
        stage_rows(rows, b0, m, W, vec, stage + u * 32 * W, lane);
    }
    if (kMax && kStage) {
      cp_async_wait_all();
      __syncwarp();
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // a lane past the batch holds slot -1 and reads no row
      const unsigned* row =
          kStage ? stage + u * 32 * Ws + lane * Ws
                 : rows + (((c0 + u * stride) << 5) + lane) * W;
      fold_lane<kShared, kCount, kMax>(s[u], a[u], row, W, n, t_count,
                                       t_packed, touched, lane);
    }
    if (kMax && kStage) __syncwarp();  // the stages are refilled next round
  }
  if (kPath == kSingle) {  // the block's tables are the result (slice = cap)
    __syncthreads();
    const uint4* s4 = reinterpret_cast<const uint4*>(tab);
    // table is the caller's buffer: 16-byte aligned where it starts so
    const bool out4 = ((uintptr_t)table & 15) == 0;
    const int n4 = out4 ? words / 4 : 0;
    uint4* d4 = reinterpret_cast<uint4*>(table);
    for (int i = threadIdx.x; i < n4; i += blockDim.x) d4[i] = s4[i];
    for (int i = 4 * n4 + threadIdx.x; i < words; i += blockDim.x)
      table[i] = (int)tab[i];
  } else if (kShared) {  // flush the touched slots of the slice
    __syncthreads();
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      if (kMax && !(touched[i >> 5] & (1u << (i & 31)))) continue;
      if (kCount) {
        const int c = t_count[i];
        if (c != 0) atomicAdd(table + lo + i, c);
      }
      if (kMax) {
        for (int w = 0; w < W; ++w) {
          const unsigned v = t_packed[i * W + w];
          if (v != 0u)
            atomicMax((unsigned*)table + c_words + (long long)(lo + i) * W + w,
                      v);
        }
      }
    }
  }
}

template <int kPath, bool kCount, bool kMax, bool kStage>
cudaError_t launch_kernel(const void* slots, const void* amounts,
                          const void* rows, long long B, int W, int cap,
                          int slice, void* table, long long blocks,
                          size_t smem, cudaStream_t st) {
  static size_t allowed = 48 * 1024;  // the most this kernel may take
  if (smem > allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        fold_kernel<kPath, kCount, kMax, kStage>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  fold_kernel<kPath, kCount, kMax, kStage>
      <<<(unsigned)blocks, kThreads, smem, st>>>(
          (const int*)slots, (const int*)amounts, (const unsigned*)rows, B,
          W, cap, slice, (int*)table);
  return cudaGetLastError();
}

// The kernel of the path. Rows are staged on single() and blocks() where
// they fit (staged(W)); sliced() and direct() read them where they lie (a
// fold without rows takes the staging kernel, which then stages nothing).
// smem is fold_smem's count for the same path and W, which no path lets
// exceed kSmemBlock.
template <int kPath, bool kCount, bool kMax>
cudaError_t launch_path(const void* slots, const void* amounts,
                        const void* rows, long long B, int W, int cap,
                        int slice, void* table, long long blocks, size_t smem,
                        cudaStream_t st) {
  if (smem > kSmemBlock) return cudaErrorInvalidValue;
  constexpr bool kTable = kPath == kSingle || kPath == kBlocks;
  if constexpr (kMax) {
    if (!kTable || !staged<kMax>(W))
      return launch_kernel<kPath, kCount, kMax, false>(
          slots, amounts, rows, B, W, cap, slice, table, blocks, smem, st);
  }
  if constexpr (!kMax || kTable)
    return launch_kernel<kPath, kCount, kMax, true>(
        slots, amounts, rows, B, W, cap, slice, table, blocks, smem, st);
  return cudaErrorInvalidValue;  // not reached
}

// Whether a table of cap slots (and, where rows are staged, the warps'
// row stages) fits in one block's shared memory: single() and blocks().
template <bool kCount, bool kMax>
inline bool fits(int W, int cap) {
  return fold_smem<kCount, kMax>(kBlocks, W, cap) <= kSmemBlock;
}

// Whether sliced() can cut a table of rows of W words: a slice of 32 slots
// fits in one block's shared memory.
template <bool kCount, bool kMax>
inline bool sliceable(int W) {
  return fold_smem<kCount, kMax>(kSliced, W, 32) <= kSmemBlock;
}

// One block folds the B elements into shared tables and writes them whole
// into the caller's table_words(W, cap) int32 buffer: no memset, no device
// atomics. Needs fits(W, cap).
template <bool kCount, bool kMax>
cudaError_t single(const void* slots, const void* amounts, const void* rows,
                   long long B, int W, int cap, void* table,
                   cudaStream_t st) {
  return launch_path<kSingle, kCount, kMax>(
      slots, amounts, rows, B, W, cap, cap, table, 1,
      fold_smem<kCount, kMax>(kBlocks, W, cap), st);
}

// Zero the caller's table_words(W, cap) buffer on the stream and read the
// number of SMs; *work says whether there is anything to fold.
template <bool kCount, bool kMax>
cudaError_t zero(void* table, long long B, int W, int cap, cudaStream_t st,
                 int* sms, bool* work) {
  *work = false;
  cudaError_t err = cudaMemsetAsync(
      table, 0, (size_t)table_words<kCount, kMax>(W, cap) * 4, st);
  if (err != cudaSuccess || B == 0 || cap == 0) return err;
  int device = 0;
  err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  *work = err == cudaSuccess;
  return err;
}

// Zero the buffer, then fold with match-aggregated device atomics straight
// into it: blocks of at least kDirectElemsPerBlock elements, at most two
// an SM.
template <bool kCount, bool kMax>
cudaError_t direct(const void* slots, const void* amounts, const void* rows,
                   long long B, int W, int cap, void* table,
                   cudaStream_t st) {
  int sms = 0;
  bool work = false;
  cudaError_t err = zero<kCount, kMax>(table, B, W, cap, st, &sms, &work);
  if (!work) return err;
  const size_t smem = fold_smem<kCount, kMax>(kDirect, W, cap);
  const long long grid = (B + kDirectElemsPerBlock - 1) / kDirectElemsPerBlock;
  return launch_path<kDirect, kCount, kMax>(
      slots, amounts, rows, B, W, cap, cap, table,
      grid < 2LL * sms ? grid : 2LL * sms, smem, st);
}

// Blocks of smem bytes of shared memory an SM can have resident: an SM
// has 228 KB of shared memory (1 KB of it kept for each block) and 2,048
// threads.
inline long long blocks_per_sm(size_t smem) {
  long long per_sm = (long long)(228 * 1024 / (smem + 1024));
  per_sm = per_sm < 2048 / kThreads ? per_sm : 2048 / kThreads;
  return per_sm > 1 ? per_sm : 1;
}

// Zero the buffer, then blocks of at least per_block elements, as many as
// fit on the card at once, fold into their own shared tables and flush
// what they touched with device atomics. Needs fits(W, cap).
template <bool kCount, bool kMax>
cudaError_t blocks(const void* slots, const void* amounts, const void* rows,
                   long long B, int W, int cap, void* table,
                   long long per_block, cudaStream_t st) {
  int sms = 0;
  bool work = false;
  cudaError_t err = zero<kCount, kMax>(table, B, W, cap, st, &sms, &work);
  if (!work) return err;
  const long long wanted = (B + per_block - 1) / per_block;
  const size_t smem = fold_smem<kCount, kMax>(kBlocks, W, cap);
  const long long room = sms * blocks_per_sm(smem);
  return launch_path<kBlocks, kCount, kMax>(
      slots, amounts, rows, B, W, cap, cap, table,
      wanted < room ? wanted : room, smem, st);
}

// blocks() for a table too large for one block's shared memory: the table
// is cut into equal slices of a multiple of 32 slots, each as large as a
// block's shared memory holds (rows are not staged); each replica of the
// grid has a block a slice. Needs sliceable(W).
template <bool kCount, bool kMax>
cudaError_t sliced(const void* slots, const void* amounts, const void* rows,
                   long long B, int W, int cap, void* table,
                   long long per_block, cudaStream_t st) {
  int sms = 0;
  bool work = false;
  cudaError_t err = zero<kCount, kMax>(table, B, W, cap, st, &sms, &work);
  if (!work) return err;
  const long long per_slot = 32 * table_words<kCount, kMax>(W, 1) + kMax;
  long long most = (long long)(kSmemBlock / 4) * 32 / per_slot;
  most -= most % 32;
  if (most < 32) return cudaErrorInvalidValue;
  long long n_slices = (cap + most - 1) / most;
  long long slice = (cap + n_slices - 1) / n_slices;
  slice += (32 - slice % 32) % 32;
  n_slices = (cap + slice - 1) / slice;  // as the kernel counts them
  const long long wanted = (B + per_block - 1) / per_block;
  const size_t smem = fold_smem<kCount, kMax>(kSliced, W, (int)slice);
  long long room = sms * blocks_per_sm(smem) / n_slices;
  room = room > 0 ? room : 1;
  const long long replicas = wanted < room ? wanted : room;
  return launch_path<kSliced, kCount, kMax>(
      slots, amounts, rows, B, W, cap, (int)slice, table, n_slices * replicas,
      smem, st);
}

}  // namespace
}  // namespace fold
