"""The fold_count_max and wedge_check CUDA kernels' algorithms, modelled
step for step on the host, against the plain PyTorch versions, the JAX
package's Pallas kernels (interpret mode) and the oracles, on skewed fold
batches and CSR-shaped push queries. The CUDA kernels themselves are held
against the plain versions on the card by chip_smoke.py. Exact equality
throughout."""
import ctypes
import re

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from repro.kernels.fold_scatter import ops as ref_fs
from repro.kernels.wedge_check import ops as ref_wc
from repro_torch.kernels import _cuda
from repro_torch.kernels.fold_scatter import ops as fs
from repro_torch.kernels.fold_scatter import ref as fs_ref
from repro_torch.kernels.fold_scatter.ref import (
    fold_count_max_numpy, fold_count_max_route, fold_count_max_warp_numpy,
    skewed_fold_inputs)
from repro_torch.kernels.wedge_check import ops as wc
from repro_torch.kernels.wedge_check.ref import (
    ROW_LENGTHS, csr_wedge_check_inputs, hub_wedge_check_inputs,
    lifting_lower_bound_numpy, lower_bound_numpy)
from test_torch_kernels import bits

# one intra-op thread: the suite runs in parallel workers, and torch's
# default of one thread per core oversubscribes the machine
torch.set_num_threads(1)

CAP = 256          # one table tile of the Pallas kernel
PALLAS_B = 512     # every batch is padded to it: one trace for every case


# ---------------------------------------------------------------------------
# fold_count_max: slot groups of uniform amounts, words max-ed where they
# exceed the table, one block or blocks with touched-slot flushes, or device
# atomics


def pallas_fold(slots, amounts, rows, cap):
    """The JAX package's Pallas kernel in interpret mode, the batch padded
    with dropped elements to PALLAS_B (as its own wrapper pads)."""
    pad = PALLAS_B - len(slots)
    s = np.concatenate([slots, np.full(pad, -1, np.int32)])
    a = np.concatenate([amounts, np.zeros(pad, np.int32)])
    r = np.concatenate([rows, np.zeros((pad, rows.shape[1]), np.uint32)])
    c, p = ref_fs.fold_count_max(jnp.asarray(s), jnp.asarray(a), jnp.asarray(r),
                                 cap, interpret=True)
    return np.asarray(c), np.asarray(p)


@pytest.mark.parametrize("case,B", [
    ("one_slot", 500), ("alternating", 333), ("zipf", 512), ("dropped", 200),
    ("zero_amounts", 300), ("extreme_words", 257), ("zipf", 1),
    ("uniform", 31), ("uniform", 33),
])
def test_fold_count_max_warp_model_equals_plain_and_pallas(case, B):
    rng = np.random.default_rng(B + len(case))
    slots, amounts, rows = skewed_fold_inputs(rng, case, B, 5, CAP)
    count, packed = fs.fold_count_max(torch.as_tensor(slots),
                                      torch.as_tensor(amounts), bits(rows), CAP)
    count, packed = count.numpy(), packed.numpy().view(np.uint32)
    want_c, want_p = pallas_fold(slots, amounts, rows, CAP)
    np.testing.assert_array_equal(count, want_c)
    np.testing.assert_array_equal(packed, want_p)
    np_c, np_p = fold_count_max_numpy(slots, amounts, rows, CAP)
    np.testing.assert_array_equal(count, np_c)
    np.testing.assert_array_equal(packed, np_p)
    kept = (slots >= 0) & (slots < CAP)
    distinct = len(np.unique(slots[kept]))
    chunks = len({int(b) // 32 for b in np.flatnonzero(kept)})
    for path, blocks, warps in (("single", 1, 32), ("blocks", 3, 2),
                                ("direct", 1, 32)):
        m_c, m_p, st = fold_count_max_warp_numpy(
            slots, amounts, rows, CAP, path=path, blocks=blocks, warps=warps)
        np.testing.assert_array_equal(m_c, count)
        np.testing.assert_array_equal(m_p, packed)
        assert st["lanes"] == int(kept.sum())
        if path == "blocks":
            assert distinct <= st["flushed"] <= blocks * distinct
        if case in ("one_slot", "alternating"):   # one add a slot and chunk
            assert st["adds"] == chunks * distinct
        if case in ("one_slot", "alternating") and path != "direct":
            assert st["maxes"] < st["lanes"]       # settled words are read
        if case in ("dropped", "zero_amounts"):
            assert st["adds"] == 0


def test_fold_count_max_warp_model_wraps_int32_sums():
    """A group's amount times its size wraps as int32 adds do, and a word
    max-ed once is not max-ed again by an equal word."""
    slots = np.zeros(64, np.int32)
    amounts = np.full(64, 2**30, np.int32)       # 32 · 2³⁰ = 2³⁵ ≡ 0 a chunk
    rows = np.zeros((64, 2), np.uint32)
    rows[7] = rows[40] = (0x80000000, 0xFFFFFFFF)
    c, p, st = fold_count_max_warp_numpy(slots, amounts, rows, 4, path="single")
    want_c, want_p = fold_count_max_numpy(slots, amounts, rows, 4)
    np.testing.assert_array_equal(c, want_c)
    np.testing.assert_array_equal(p, want_p)
    assert st["adds"] == 2 and st["maxes"] == 2
    plain_c, plain_p = fs.fold_count_max_plain(
        torch.as_tensor(slots), torch.as_tensor(amounts), bits(rows), 4)
    np.testing.assert_array_equal(plain_c.numpy(), c)
    np.testing.assert_array_equal(plain_p.numpy().view(np.uint32), p)


def test_fold_count_max_route_fits_shared_memory_at_every_width():
    """The modelled route choice asks no block for more than 232,448 bytes
    for W in 1…128: rows are staged (W ≤ 14) only where the table fits
    beside the stages, which is then the route and byte count of the
    kernel before rows were ever read unstaged; every table too large for
    shared memory beside them is cut into slices (one where it fits
    without the stages), whatever W; device atomics only
    where a slice of 32 slots does not fit (W > 1,814). The model's
    constants are the sources'."""
    csrc = _cuda.CSRC
    body = (csrc / "fold_common.cuh").read_text()
    consts = {m[1]: int(m[2]) for m in re.finditer(
        r"constexpr int (kThreads|kUnroll) = (\d+);", body)}
    assert consts == {"kThreads": 32 * fs_ref.FOLD_WARPS,
                      "kUnroll": fs_ref.FOLD_UNROLL}
    assert "kSmemBlock = 227 * 1024;" in body
    assert fs_ref.SMEM_BLOCK == 232_448
    assert (f"kFoldSingleMaxB = {fs_ref.FOLD_SINGLE_MAX_B};"
            in (csrc / "fold_scatter.cu").read_text())
    for W in range(1, 129):
        stage = 16_384 * W
        for cap in (16, 4096, 262_144):
            tables = (cap * (1 + W) + (cap + 31) // 32) * 4
            fits = (stage if W <= 14 else 0) + tables <= 232_448
            for B in (1, 16_384, 16_385):
                r = fold_count_max_route(B, W, cap)
                assert r["smem"] <= 232_448, (W, cap, B)
                assert r["staged"] == (W <= 14 and fits)
                if fits:
                    assert r["path"] == ("single" if B <= 16_384 else "blocks")
                    assert r["slices"] == 1
                    assert r["smem"] == (stage if W <= 14 else 0) + tables
                else:
                    assert r["path"] == "blocks", (W, cap)
                    # one slice where the table fits without the stages
                    assert (r["slices"] > 1) == (tables > 232_448)
    assert fold_count_max_route(1, 15, 16)["path"] == "single"
    assert fold_count_max_route(16_385, 16, 4096) == dict(
        path="blocks", staged=False, smem=(2048 * 17 + 64) * 4, slices=2)
    assert fold_count_max_route(1, 1814, 4096)["path"] == "blocks"
    assert fold_count_max_route(1, 1815, 4096) == dict(
        path="direct", staged=False, smem=0, slices=1)


@pytest.mark.parametrize("W,cap,B", [(5, 65_536, 20_000), (14, 16_384, 3000)])
def test_fold_count_max_sliced_narrow_rows_model_equals_plain(W, cap, B):
    """A table of rows of W ≤ 14 words too large for shared memory takes
    table slices with rows read where they lie, as wide rows do; the
    modelled fold on that route equals the plain version."""
    rng = np.random.default_rng(W * B + cap)
    slots, amounts, rows = skewed_fold_inputs(rng, "zipf", B, W, cap)
    slots[::7] = rng.integers(0, cap, len(slots[::7]))   # every slice too
    route = fold_count_max_route(B, W, cap)
    assert route["path"] == "blocks" and route["slices"] > 1
    assert not route["staged"]
    count, packed = fs.fold_count_max(torch.as_tensor(slots),
                                      torch.as_tensor(amounts), bits(rows), cap)
    m_c, m_p, st = fold_count_max_warp_numpy(
        slots, amounts, rows, cap, path="blocks", blocks=1,
        slices=route["slices"])
    np.testing.assert_array_equal(m_c, count.numpy())
    np.testing.assert_array_equal(m_p, packed.numpy().view(np.uint32))
    assert st["lanes"] == int(((slots >= 0) & (slots < cap)).sum())


@pytest.mark.parametrize("W", [15, 16])
@pytest.mark.parametrize("cap,B", [(64, 700), (64, 20_000), (4096, 3000),
                                   (16_384, 20_000)])
def test_fold_count_max_wide_rows_model_equals_plain(W, cap, B):
    """At W = 15 and 16 the modelled fold on the route the launcher takes
    (one block, blocks, or blocks on table slices) equals the plain
    version."""
    rng = np.random.default_rng(W * B + cap)
    slots, amounts, rows = skewed_fold_inputs(rng, "zipf", B, W, cap)
    route = fold_count_max_route(B, W, cap)
    assert not route["staged"]
    count, packed = fs.fold_count_max(torch.as_tensor(slots),
                                      torch.as_tensor(amounts), bits(rows), cap)
    m_c, m_p, st = fold_count_max_warp_numpy(
        slots, amounts, rows, cap, path=route["path"],
        blocks=3 if route["path"] == "blocks" else 1, slices=route["slices"])
    np.testing.assert_array_equal(m_c, count.numpy())
    np.testing.assert_array_equal(m_p, packed.numpy().view(np.uint32))
    assert st["lanes"] == int(((slots >= 0) & (slots < cap)).sum())


# ---------------------------------------------------------------------------
# wedge_check: binary lifting on (d, h), then the walk over id ties


def test_wedge_check_lifting_model_equals_plain_and_pallas():
    rng = np.random.default_rng(15)
    args = csr_wedge_check_inputs(rng, 2, 400)
    kd, kh, ki, lo, hi, qd, qh, qi = args
    assert set(ROW_LENGTHS) <= set((hi - lo).ravel().tolist())
    assert (kh >= 2**31).any() and (qh >= 2**31).any()
    plain = wc.wedge_check(torch.as_tensor(kd), bits(kh), torch.as_tensor(ki),
                           torch.as_tensor(lo), torch.as_tensor(hi),
                           torch.as_tensor(qd), bits(qh),
                           torch.as_tensor(qi)).numpy()
    walked = 0
    for s in range(2):
        one = tuple(x[s] for x in args)
        pos, w = lifting_lower_bound_numpy(*one)
        walked += w
        np.testing.assert_array_equal(pos, plain[s])
        np.testing.assert_array_equal(pos, lower_bound_numpy(*one))
        want = np.asarray(ref_wc.wedge_check(*map(jnp.asarray, one), bq=128,
                                             interpret=True))
        np.testing.assert_array_equal(pos, want)
        qlo, qhi = one[3], one[4]
        assert (pos[one[5] == -1] == qlo[one[5] == -1]).all()   # below all
        assert (pos[one[5] == 7] == qhi[one[5] == 7]).all()     # above all
    assert walked > 0                # (d, h) ties broken by id are walked


def test_wedge_check_hub_shaped_search_equals_oracle():
    """The hub lane's search (one flattened row of stable-key hub rows, up
    to 3,000 keys here): the plain version, the kernel's lifting model and
    the bisect oracle agree, and queries below and above every key land
    on their row's ends."""
    rng = np.random.default_rng(17)
    args = hub_wedge_check_inputs(rng, 5, 600, max_len=3000)
    kd, kh, ki, lo, hi, qd, qh, qi = args
    assert all((kd[0][a:b] == 0).all() for a, b in zip(lo[0], hi[0]))
    plain = wc.wedge_check(torch.as_tensor(kd), bits(kh), torch.as_tensor(ki),
                           torch.as_tensor(lo), torch.as_tensor(hi),
                           torch.as_tensor(qd), bits(qh),
                           torch.as_tensor(qi)).numpy()[0]
    one = tuple(x[0] for x in args)
    pos, _ = lifting_lower_bound_numpy(*one)
    np.testing.assert_array_equal(pos, plain)
    np.testing.assert_array_equal(pos, lower_bound_numpy(*one))
    below, above = qi[0] == -1, qi[0] == 2**31 - 1
    assert (plain[below] == lo[0][below]).all() and below.any()
    assert (plain[above] == hi[0][above]).all() and above.any()


# ---------------------------------------------------------------------------
# the C entry points' signatures are set once


def test_cuda_function_sets_the_signature_once(monkeypatch):
    calls = []

    class Lib:
        @property
        def tripoll_probe(self):
            calls.append(1)
            return ctypes.CFUNCTYPE(ctypes.c_int)(lambda: 0)

    monkeypatch.setattr(_cuda, "library", lambda name: Lib())
    monkeypatch.setattr(_cuda, "_fns", {})
    f = _cuda.function("probe_lib", "tripoll_probe", [_cuda.PTR, _cuda.I64])
    g = _cuda.function("probe_lib", "tripoll_probe", [_cuda.PTR, _cuda.I64])
    assert f is g and len(calls) == 1
    assert f.restype is ctypes.c_int
    assert list(f.argtypes) == [ctypes.c_void_p, ctypes.c_longlong]
