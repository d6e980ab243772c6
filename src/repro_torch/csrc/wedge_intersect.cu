// wedge_intersect: fused candidate addressing + lower bound in pulled rows.
//
// Replaces src/repro/kernels/wedge_intersect/wedge_intersect.py::
// wedge_intersect_pallas (the Pallas TPU kernel of the pull lane, called
// from core/engine.py::_pull_compute with pull_kernel "auto"/"fused").
//
// For pulled edge b and lane k < L: idx = clamp(e[b] + 1 + k, 0, E - 1);
// the candidate key (kd, kh, ki)[idx] is lower-bounded in the edge's pulled
// row (row_d, row_h, row_i)[b, 0:ln[b]] under the (degree, hash as
// unsigned, id) order. Outputs pos[b, k] and ci[b, k] = ki[idx]. The row
// prefix is sorted (it is the owner's CSR row); ln <= Lr on the engine's
// path, and a longer prefix reads as row[Lr - 1] repeated, as the plain
// version's clamped probes read it.
//
// What bounds it on an H100: the bytes. The engine pads every pulled edge
// to L lanes, so the 8 * B * L bytes of outputs (805 MB at B = 239,096,
// L = 421) come first, then the rows' probed keys and the candidate keys:
// 0.33 ms at 3.35 TB/s in the fullest window. The searches come next:
// ~100 M lower bounds of up to 9 probes each.
//
// Design: a warp per pulled edge, eight warps a block, three blocks an SM
// (the rest of the SM's memory left to L1, which holds the key windows
// that neighbouring edges share), a persistent grid walking the edges; no
// block barrier.
// - The warp stages its edge's row prefix in its own shared memory with
//   cp.async (4-byte granules: rows start at b * Lr * 4 bytes), (d, h) as
//   one 64-bit word, h in the low half and d in the high half, so that one
//   signed 64-bit compare orders (d signed, h unsigned). The slots past ln
//   up to twice the search's first step hold a key above all keys, so the
//   probes need no bound check.
// - Lane l takes candidates k = l, l + 32, ...: each round of 32 lanes
//   reads 32 consecutive key slots and writes 32 consecutive outputs.
//   Four rounds are searched in lockstep (four independent probes in
//   flight a lane) while the next four rounds' keys load.
// - The search is binary lifting on the (d, h) word from the highest power
//   of two <= ln: every lane takes the same steps, so nothing diverges, and
//   a probe is an add, a 64-bit load and compare, and a conditional add.
//   Row keys that tie the candidate's (d, h) follow, ordered by id; a walk
//   over them (almost always no step) finishes the exact lower bound.
// - An edge with an empty row writes positions 0 and copies its ids, all
//   sixteen rounds' loads in flight before their stores.
// At the fullest window of the scale-18 cell (tools/kernel_ab.py, PERF.md)
// a block per edge with a branching binary search per lane took 1.41 ms,
// this design about 0.75 ms. Tried on the same inputs and dropped:
// contiguous chunks of candidates a lane, galloping along non-decreasing
// runs of keys from the previous lower bound, with double-buffered cp.async
// staging (the lanes' searches diverge and each lane's chain of dependent
// probes is long: 4.0 ms); a bank swizzle of the row (more instructions,
// no gain); double-buffered rows (fewer resident warps); two or eight
// rounds in lockstep.
//
// Rows too wide for eight warps' rows in shared memory take a
// device-memory path: a thread per lane, a binary search in device memory.
//
// Built by repro_torch/kernels/_cuda.py with nvcc for sm_90a; C interface
// for ctypes. Returns the first CUDA error of the launch, or 0.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;        // warps a block of the staged kernel
constexpr int kGroup = 4;        // rounds of 32 lanes searched in lockstep
constexpr int kCopyRounds = 16;  // rounds of ids in flight on an empty row
constexpr int kBlocksPerSM = 3;  // shared memory is carved out for these

// (d, h) as one word whose signed order is (d signed, h unsigned)
__device__ __forceinline__ long long dh_word(int d, unsigned h) {
  return (long long)(((unsigned long long)(unsigned)d << 32) | h);
}

__device__ __forceinline__ bool key_less(long long adh, int ai, long long bdh,
                                         int bi) {
  return adh < bdh || (adh == bdh && ai < bi);
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The highest power of two <= n, or 0.
__host__ __device__ inline int pow2_floor(int n) {
#ifdef __CUDA_ARCH__
  return n > 0 ? 1 << (31 - __clz(n)) : 0;
#else
  int p = 0;
  for (long long q = 1; q <= n; q *= 2) p = (int)q;
  return p;
#endif
}

// Keys a warp's row slice holds: the search from top = pow2_floor(ln)
// probes slots up to 2 * top - 2.
__host__ __device__ inline long long slice_keys(int Lr) {
  return Lr > 0 ? 2LL * pow2_floor(Lr) : 0;
}

// Bytes of a warp's row slice: the (d, h) words, then the ids.
__host__ __device__ inline long long slice_bytes(int Lr) {
  return 12 * slice_keys(Lr);
}

struct Args {
  const int* kd;
  const unsigned* kh;
  const int* ki;
  long long E;
  const int* e;
  const int* row_d;
  const unsigned* row_h;
  const int* row_i;
  const int* ln;
  long long B;
  int Lr, L;
  int* pos;
  int* ci;
};

// Copy edge b's row prefix of nl > 0 keys into the warp's slice, and fill
// the slots the search may probe past nl with the key above all keys.
__device__ __forceinline__ void stage(const Args& A, long long* dh, int* id,
                                      long long b, int nl, int lane) {
  const long long row0 = b * A.Lr;
  int* dh_w = reinterpret_cast<int*>(dh);
  for (int j = lane; j < nl; j += 32) {
    cp_async4(dh_w + 2 * j, A.row_h + row0 + j);
    cp_async4(dh_w + 2 * j + 1, A.row_d + row0 + j);
    cp_async4(id + j, A.row_i + row0 + j);
  }
  const int end = 2 * pow2_floor(nl) - 1;
  for (int j = nl + lane; j < end; j += 32) {
    dh[j] = 0x7fffffffffffffffLL;
    id[j] = 0x7fffffff;
  }
  cp_async_wait_all();
  __syncwarp();  // every lane's copies and fills are in place
}

// The key slot of lane k: e + 1 + k, clamped into [0, E).
__device__ __forceinline__ long long clamped_slot(const Args& A,
                                                  long long e_1, int k) {
  const long long idx = e_1 + k;
  return idx < 0 ? 0 : (idx >= A.E ? A.E - 1 : idx);
}

// A round group's candidates: the keys of kGroup rounds of 32 lanes.
struct Cands {
  long long dh[kGroup];
  int id[kGroup];
};

// Lanes past L read lane L - 1's slot. Without kClamp the edge's window
// [e + 1, e + L] lies inside [0, E), and e + 1 + k is the slot.
template <bool kClamp>
__device__ __forceinline__ Cands load_cands(const Args& A, long long e_1,
                                            int r0, int lane) {
  Cands c;
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    const int k = min((r0 + g) * 32 + lane, A.L - 1);
    const long long idx = kClamp ? clamped_slot(A, e_1, k) : e_1 + k;
    c.id[g] = A.ki[idx];
    c.dh[g] = dh_word(A.kd[idx], A.kh[idx]);
  }
  return c;
}

// Positions and ids of one pulled edge whose staged row has nl > 0 keys.
template <bool kClamp>
__device__ __forceinline__ void search_edge(const Args& A,
                                            const long long* rdh,
                                            const int* rid, int n, int nl,
                                            long long e_1, int* pos, int* ci,
                                            int lane) {
  const int rounds = (A.L + 31) >> 5;
  const char* row = reinterpret_cast<const char*>(rdh);
  const int top8 = 8 * pow2_floor(nl);  // the first step, in bytes
  Cands cur = load_cands<kClamp>(A, e_1, 0, lane);
  for (int r0 = 0; r0 < rounds; r0 += kGroup) {
    const Cands nxt =
        load_cands<kClamp>(A, e_1, min(r0 + kGroup, rounds - 1), lane);
    // binary lifting on the (d, h) word: p8 / 8 counts the row keys whose
    // word is below the candidate's
    int p8[kGroup] = {};
    for (int s8 = top8; s8 >= 8; s8 >>= 1) {
      long long x[kGroup];
#pragma unroll
      for (int g = 0; g < kGroup; ++g)
        x[g] = *reinterpret_cast<const long long*>(row + p8[g] + s8 - 8);
#pragma unroll
      for (int g = 0; g < kGroup; ++g) p8[g] += x[g] < cur.dh[g] ? s8 : 0;
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      int p = p8[g] >> 3;
      while (p < nl && rdh[p] == cur.dh[g] && rid[p] < cur.id[g]) ++p;
      const int k = (r0 + g) * 32 + lane;
      if (k < A.L) {
        pos[k] = (p == nl && n > nl) ? n : p;
        ci[k] = cur.id[g];
      }
    }
    cur = nxt;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
    wedge_intersect_staged(Args A) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  unsigned char* mine = smem + warp * slice_bytes(A.Lr);
  long long* rdh = reinterpret_cast<long long*>(mine);
  int* rid = reinterpret_cast<int*>(mine + 8 * slice_keys(A.Lr));
  const int rounds = (A.L + 31) >> 5;
  const long long nw = (long long)gridDim.x * kWarps;
  long long b = (long long)blockIdx.x * kWarps + warp;
  int n0 = 0, e0 = 0;  // ln and e of this edge, loaded one edge ahead
  if (b < A.B) {
    n0 = A.ln[b];
    e0 = A.e[b];
  }
  for (; b < A.B; b += nw) {
    const int nl = n0 < 0 ? 0 : min(n0, A.Lr);
    const long long e_1 = (long long)e0 + 1;
    int* pos = A.pos + b * A.L;
    int* ci = A.ci + b * A.L;
    int n1 = 0, e1 = 0;
    if (b + nw < A.B) {
      n1 = A.ln[b + nw];
      e1 = A.e[b + nw];
    }
    const bool clamp = e_1 < 0 || e_1 + A.L > A.E;
    if (nl == 0) {
      for (int r0 = 0; r0 < rounds; r0 += kCopyRounds) {
        int v[kCopyRounds];
#pragma unroll
        for (int g = 0; g < kCopyRounds; ++g) {
          const int k = min((r0 + g) * 32 + lane, A.L - 1);
          v[g] = A.ki[clamp ? clamped_slot(A, e_1, k) : e_1 + k];
        }
#pragma unroll
        for (int g = 0; g < kCopyRounds; ++g) {
          const int k = (r0 + g) * 32 + lane;
          if (k < A.L) {
            pos[k] = 0;
            ci[k] = v[g];
          }
        }
      }
    } else {
      stage(A, rdh, rid, b, nl, lane);
      if (clamp) {
        search_edge<true>(A, rdh, rid, n0, nl, e_1, pos, ci, lane);
      } else {
        search_edge<false>(A, rdh, rid, n0, nl, e_1, pos, ci, lane);
      }
      __syncwarp();  // every lane is done with this row
    }
    n0 = n1;
    e0 = e1;
  }
}

__global__ void wedge_intersect_global(Args A) {
  const long long lanes = A.B * A.L;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       t < lanes; t += (long long)gridDim.x * blockDim.x) {
    const long long b = t / A.L;
    const int k = (int)(t - b * A.L);
    const int n = A.ln[b];
    const int nl = n < 0 ? 0 : (n > A.Lr ? A.Lr : n);
    const long long idx = clamped_slot(A, (long long)A.e[b] + 1, k);
    const long long kdh = dh_word(A.kd[idx], A.kh[idx]);
    const int kid = A.ki[idx];
    const long long row0 = b * A.Lr;
    int lo = 0, hi = nl;
    while (lo < hi) {
      const int mid = (lo + hi) >> 1;
      const long long m = row0 + mid;
      if (key_less(dh_word(A.row_d[m], A.row_h[m]), A.row_i[m], kdh, kid)) {
        lo = mid + 1;
      } else {
        hi = mid;
      }
    }
    A.pos[t] = (lo == nl && n > nl) ? n : lo;
    A.ci[t] = kid;
  }
}

}  // namespace

extern "C" int tripoll_wedge_intersect(const void* kd, const void* kh,
                                       const void* ki, long long E,
                                       const void* e, const void* row_d,
                                       const void* row_h, const void* row_i,
                                       const void* ln, long long B, int Lr,
                                       int L, void* pos, void* ci,
                                       void* stream) {
  const Args A{(const int*)kd,          (const unsigned*)kh,
               (const int*)ki,          E,
               (const int*)e,           (const int*)row_d,
               (const unsigned*)row_h,  (const int*)row_i,
               (const int*)ln,          B,
               Lr,                      L,
               (int*)pos,               (int*)ci};
  cudaStream_t st = (cudaStream_t)stream;
  int device = 0, sms = 0, optin = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return (int)err;
  const long long smem = kWarps * slice_bytes(Lr);
  if (smem <= optin) {
    err = cudaFuncSetAttribute(wedge_intersect_staged,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    // shared memory for kBlocksPerSM blocks (and their 1 KB each of
    // reserve), the rest of the SM's 228 KB carveout left to L1
    const long long carve = (100 * kBlocksPerSM * (smem + 1024) + 233471) / 233472;
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(wedge_intersect_staged,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)(carve < 100 ? carve : 100));
    int per_sm = 0;
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, wedge_intersect_staged, kWarps * 32, (size_t)smem);
    if (err != cudaSuccess) return (int)err;
    if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
    long long blocks = (B + kWarps - 1) / kWarps;
    if (blocks > (long long)sms * per_sm) blocks = (long long)sms * per_sm;
    wedge_intersect_staged<<<(unsigned)blocks, kWarps * 32, (size_t)smem,
                             st>>>(A);
  } else {
    const int threads = 256;
    long long blocks = (B * L + threads - 1) / threads;
    if (blocks > (long long)sms * 32) blocks = (long long)sms * 32;
    wedge_intersect_global<<<(unsigned)blocks, threads, 0, st>>>(A);
  }
  return (int)cudaGetLastError();
}
