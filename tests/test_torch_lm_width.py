"""The checks of ``chip_smoke.py``'s full-width LM paths, on the CPU.

Path p holds one kimi-k2 layer's MoE on the card to two things written in
``chip_smoke.py``: ``moe_route_host``, the routing recomputed in numpy
from the router's probabilities, and ``moe_oracle``, the layer's output
computed expert by expert in float32. Here both are held to the port's
``moe_layer`` at the SMOKE widths of kimi-k2 (top 4 of 12 experts) and
llama4 (top 1 of 8): a capacity small enough to drop assignments, with
and without ``group_chunks``, and tied router columns; the routing
exactly, the output within float32 rounding. ``layers.truncated_normal``,
which draws, scales and casts a chunk at a time, is held bit for bit to
the full-tensor formula, and the twin's int32 hash to numpy's past flat
index 2³². Paths o and p are rehearsed at SMOKE widths with a small
traffic. No JAX here: ``tests/test_torch_moe.py`` holds ``moe_layer`` to
the reference.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.configs import get_arch
from repro_torch.models import layers, moe, threefry

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
try:
    import chip_smoke
finally:
    sys.path.remove(str(ROOT))

CPU = torch.device("cpu")
RTOL = 1e-5              # the oracle's float32 sums in another order
T = 128                  # tokens: four dispatch groups of 32
MOE_ARCHS = ("kimi-k2-1t-a32b", "llama4-maverick-400b-a17b")
# capacity factors small enough that a group drops assignments
CASES = {"drops": dict(capacity_factor=0.5),
         "chunks": dict(capacity_factor=0.5, group_chunks=2),
         "ties": dict(capacity_factor=0.5)}


@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_truncated_normal_chunks_equal_full_draw(monkeypatch, dtype):
    """Drawn 1,000 elements at a time into ``dtype`` == the whole float32
    draw times the float32 scale, cast (shapes past a whole chunk)."""
    key = threefry.prng_key(5)
    for shape, scale in (((3, 1001), 0.037), ((2, 500), 1.0), ((7,), 2.5)):
        z = threefry.torch_truncated_normal(key, -2.0, 2.0, shape, CPU)
        want = (torch.tensor(np.float32(scale)) * z).to(dtype)
        monkeypatch.setattr(threefry, "_CHUNK", 1000)
        got = layers.truncated_normal(key, shape, scale, dtype, CPU)
        monkeypatch.undo()
        assert got.dtype == dtype and got.shape == shape
        assert torch.equal(got.view(-1).view(torch.uint8),
                           want.view(-1).view(torch.uint8))
    meta = layers.truncated_normal(key, (4, 5), 0.5, dtype, "meta")
    assert meta.is_meta and meta.dtype == dtype and meta.shape == (4, 5)


def test_twin_bits_past_two_to_the_32_equal_numpy():
    """The twin's int32 hash at flat indices whose high word is not 0 (a
    kimi-k2 expert leaf holds 5.6 G elements) == the numpy hash."""
    key = threefry.prng_key(9)
    start = 2**32 - 1000
    idx = np.arange(start, start + 3000, dtype=np.uint64)
    b0, b1 = threefry._threefry2x32(key, (idx >> np.uint64(32)).astype(np.uint32),
                                    (idx & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    got = threefry._bits_chunk(key, start, 3000, CPU).numpy()
    assert np.array_equal(got, (b0 ^ b1).astype(np.int64))


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_host_routing_and_oracle_equal_moe_layer(arch, case):
    cfg = get_arch(arch).SMOKE
    spec = dataclasses.replace(cfg.moe, **CASES[case])
    p = {k: v[0] for k, v in moe.init_moe_params(
        threefry.prng_key(1), cfg.d_model, spec, 1, torch.float32, CPU).items()}
    if case == "ties":
        # each even expert's router column copied to the next: the pair's
        # probabilities tie, and the lower expert comes first
        p["router"] = p["router"].clone()
        p["router"][:, 1::2] = p["router"][:, 0::2]
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=(T, cfg.d_model)).astype(np.float32))
    cap = chip_smoke.MoECapture()
    try:
        y, _ = moe.moe_layer(x, p, spec)
    finally:
        cap.restore()
    assert moe.route is cap.route and moe.moe_layer is cap.layer
    (call,) = cap.calls
    assert call["y"] is y
    got = chip_smoke.moe_call_check(torch, call, spec)
    assert got["equal"] == dict(eidx=True, pos=True, keep=True), got
    assert got["dropped"] > 0 and got["oracle_rel_err"] <= RTOL, got
    assert got["groups"] == T // spec.group_size
    if case == "ties":
        probs = call["routing"].probs
        assert torch.equal(probs[..., 0::2], probs[..., 1::2])
        assert (call["routing"].eidx[..., 0] % 2 == 0).all()


def test_rehearse_path_o_smoke():
    """Path o at SMOKE widths (phi3's MHA model) through ``serve.main``."""
    full = {}
    out = chip_smoke.path_lm(torch, CPU, full, widths="SMOKE",
                             name="lm_phi3", traffic=(2, 32, 64))
    assert full["lm_phi3"] is out and out["arch"] == "phi3-mini-3.8b"
    assert "twin" not in out and "smoke" not in out
    assert sorted(out["bf16_decode_checks"]) == [1, 63]
    assert sorted(out["cache_checks"]) == [1, 16]
    assert all(c["ok"] for c in out["cache_checks"].values())


def test_rehearse_path_p_smoke():
    """Path p at SMOKE widths: the prefill drops assignments, a decode
    step of two tokens none; both held to the host and the oracle."""
    full = {}
    out = chip_smoke.path_moe(torch, CPU, full, widths="SMOKE",
                              traffic=(2, 64, 16))
    assert full["moe"] is out and out["layers"] == 1
    pre, dec = out["moe_checks"]["prefill"], out["moe_checks"]["decode step 1"]
    assert pre["ok"] and dec["ok"] and pre["groups"] == 4
    assert pre["dropped"] > 0 and out["decode_dropped"] == [0] * 15
    assert sorted(out["decode_checks"]) == [1, 15]
    assert all(c["ok"] for c in out["decode_checks"].values())
    assert out["predicted_peak_bytes"] > out["weights_bytes"] > 0
