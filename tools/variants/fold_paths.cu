// Each path of the fold body (src/repro_torch/csrc/fold_common.cuh) on its
// own, whatever the batch size, for tools/kernel_ab.py's sweeps: the
// crossovers that set the launchers' limits (kFoldSingleMaxB in
// fold_scatter.cu, kAdd*MaxB and kMaxSingleMaxB in hist.cu).
//
// kind: 0 fold_count_max's fold (count and max), 1 hist_add's (count),
// 2 hist_max's (max). path: 0 one block, 1 blocks (on slices of the table
// where it does not fit in shared memory), 2 device atomics. table: the
// fold's table_words(W, cap) int32 buffer (count, then packed).
//
// Built by tools/kernel_ab.py with the port's nvcc flags and its csrc on
// the include path.
#include <cuda_runtime.h>

#include "fold_common.cuh"

namespace {

template <bool kCount, bool kMax>
cudaError_t fold_path(int path, const void* slots, const void* amounts,
                      const void* rows, long long B, int W, int cap,
                      void* table, long long per_block, cudaStream_t st) {
  const bool whole = fold::fits<kCount, kMax>(W, cap);
  if (path == 0)
    return whole ? fold::single<kCount, kMax>(slots, amounts, rows, B, W, cap,
                                              table, st)
                 : cudaErrorInvalidValue;
  if (path == 1)
    return whole ? fold::blocks<kCount, kMax>(slots, amounts, rows, B, W, cap,
                                              table, per_block, st)
                 : fold::sliced<kCount, kMax>(slots, amounts, rows, B, W, cap,
                                              table, per_block, st);
  return fold::direct<kCount, kMax>(slots, amounts, rows, B, W, cap, table,
                                    st);
}

}  // namespace

// Whether the fold of `kind` has its one-block path at (W, cap).
extern "C" int tripoll_fold_fits(int kind, int W, int cap) {
  if (kind == 0) return fold::fits<true, true>(W, cap);
  if (kind == 1) return fold::fits<true, false>(W, cap);
  return fold::fits<false, true>(W, cap);
}

extern "C" int tripoll_fold_path(int kind, int path, const void* slots,
                                 const void* amounts, const void* rows,
                                 long long B, int W, int cap, void* table,
                                 long long per_block, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (kind == 0)
    return (int)fold_path<true, true>(path, slots, amounts, rows, B, W, cap,
                                      table, per_block, st);
  if (kind == 1)
    return (int)fold_path<true, false>(path, slots, amounts, nullptr, B, 0,
                                       cap, table, per_block, st);
  return (int)fold_path<false, true>(path, slots, nullptr, rows, B, W, cap,
                                     table, per_block, st);
}
