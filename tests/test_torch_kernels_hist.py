"""The hist_add and hist_max CUDA kernels' fold (the fold body they share
with fold_count_max, ``csrc/fold_common.cuh``), modelled step for step on
the host, against the plain PyTorch versions, the JAX package's Pallas
kernels (interpret mode) and the oracles, on the shape classes of their
four callers: LocalVertexCount's 262,144-slot table with repeated ids,
MaxEdgeLabelDist's 16 slots, ClosureTime's 4,096 bins with a few hot ones,
LabelTripleSet's 4,096 counts and [4,096, 5] rows. The first port's
kernels, which ``csrc/hist.cu`` keeps for the batch sizes where they are
faster (and for hist_max's rows too wide to stage and tables too large for
shared memory), add one element at a time: the oracles' loops. The CUDA kernels
themselves are held against the plain versions on the card by
chip_smoke.py. Exact equality throughout."""
import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels.hist import ops as ref_hist
from repro_torch.kernels.hist import ops as hist
from repro_torch.kernels.hist.ref import (hist_add_numpy, hist_add_warp_numpy,
                                          hist_max_numpy, hist_max_warp_numpy)
from repro_torch.kernels.fold_scatter.ref import skewed_fold_inputs
from test_torch_kernels import bits

torch.set_num_threads(1)

# the paths of the fold body that hist_add's launcher takes: for a table
# that fits in one block's shared memory one block, or blocks (3 × 2 warps);
# for a larger one (LocalVertexCount's) device atomics, or blocks (2 × 2
# warps) on 5 slices of the table. hist_max's takes the one-block path.
SHARED_SLOTS = 227 * 1024 // 4
SHARED_PATHS = (dict(path="single"), dict(path="blocks", blocks=3, warps=2))
WIDE_PATHS = (dict(path="direct"),
              dict(path="blocks", blocks=2, warps=2, slices=5))

# caller shape classes: (case, B, cap)
ADD_CASES = [
    ("repeated_ids", 300, 262144),   # LocalVertexCount: 3 ids a triangle
    ("repeated_ids", 97, 262144),
    ("sixteen", 200, 16),            # MaxEdgeLabelDist
    ("one_slot", 65, 16),
    ("dropped", 40, 16),
    ("hot_bins", 256, 4096),         # ClosureTime
    ("zipf", 129, 4096),             # LabelTripleSet's count
    ("wrap", 100, 4096),             # group sums wrap as int32
    ("uniform", 33, 4096),           # mixed amounts: lanes add one by one
]
MAX_CASES = [("zipf", 200), ("one_slot", 64), ("extreme_words", 77),
             ("dropped", 31), ("uniform", 130)]


def pallas_add(slots, amounts, cap):
    return np.asarray(ref_hist.hist_add(
        jnp.asarray(slots), jnp.asarray(amounts), cap, bb=64,
        cap_tile=min(cap, 32768), interpret=True))


@pytest.mark.parametrize("case,B,cap", ADD_CASES)
def test_hist_add_model_equals_plain_and_pallas(case, B, cap):
    rng = np.random.default_rng(B + cap + len(case))
    slots, amounts, _ = skewed_fold_inputs(rng, case, B, 1, cap)
    plain = hist.hist_add(torch.as_tensor(slots), torch.as_tensor(amounts),
                          cap).numpy()
    np.testing.assert_array_equal(plain, pallas_add(slots, amounts, cap))
    np.testing.assert_array_equal(plain, hist_add_numpy(slots, amounts, cap))
    kept = (slots >= 0) & (slots < cap)
    for path in SHARED_PATHS if cap <= SHARED_SLOTS else WIDE_PATHS:
        got, st = hist_add_warp_numpy(slots, amounts, cap, **path)
        np.testing.assert_array_equal(got, plain)
        assert st["lanes"] == int(kept.sum()) and st["maxes"] == 0
        if path.get("slices"):
            # each slice's blocks flush their non-zero counts
            distinct = len(np.unique(slots[kept & (amounts != 0)]))
            assert distinct <= st["flushed"] <= 2 * distinct
        if path["path"] != "direct":
            # shared tables: one update a kept lane of non-zero amount
            assert st["adds"] == int((kept & (amounts != 0)).sum())
        elif case not in ("uniform", "dropped"):
            # device atomics, the kept amounts agree: one update per slot
            # a chunk, fewer than one a lane
            chunks = {int(b) // 32 for b in np.flatnonzero(kept)}
            groups = sum(len(np.unique(slots[32 * c:32 * c + 32][
                kept[32 * c:32 * c + 32]])) for c in chunks)
            assert st["adds"] == groups < st["lanes"]
    if case == "wrap":
        assert (plain != (np.bincount(slots[kept], minlength=cap)
                          * (2**30 + 7))).any()


@pytest.mark.parametrize("case,B", MAX_CASES)
def test_hist_max_model_equals_plain_and_pallas(case, B):
    cap = 4096          # LabelTripleSet's rows: [4,096, 5]
    rng = np.random.default_rng(B + len(case))
    slots, _, rows = skewed_fold_inputs(rng, case, B, 5, cap)
    plain = hist.hist_max(torch.as_tensor(slots), bits(rows),
                          cap).numpy().view(np.uint32)
    pallas = np.asarray(ref_hist.hist_max(jnp.asarray(slots),
                                          jnp.asarray(rows), cap, bb=64,
                                          cap_tile=512, interpret=True))
    np.testing.assert_array_equal(plain, pallas)
    np.testing.assert_array_equal(plain, hist_max_numpy(slots, rows, cap))
    kept = (slots >= 0) & (slots < cap)
    got, st = hist_max_warp_numpy(slots, rows, cap, path="single")
    np.testing.assert_array_equal(got, plain)
    assert st["lanes"] == int(kept.sum()) and st["adds"] == 0
    # a word updates only where it exceeds the table's
    assert st["maxes"] <= int((rows[kept] != 0).sum())
    if case == "one_slot":
        # a hot slot's words settle: fewer updates than non-zero words
        assert st["maxes"] < int((rows[kept] != 0).sum())
