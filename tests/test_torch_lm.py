"""The port's LM serving path vs the JAX package's.

At the ``SMOKE`` widths of the three dense LMs (internlm2, phi3,
command-r), the reference's weights carried across
(``interop.lm_params_from_jax``):

- ``init_params`` from a threefry key equal to ``jax.random``'s within
  ``INIT_ATOL`` (the truncated normal's float32 rounding);
- ``forward`` (logits, aux loss, the prefill cache), ``loss_fn``'s value
  and ``decode_step`` from ``init_cache`` and from a padded prefill cache
  within ``FWD_RTOL`` of the largest value (one jitted reference function
  an architecture, shared by a module fixture);
- internlm2 with bfloat16 activations and weights within ``BF16_RTOL``;
- ``rms_norm``, ``apply_rope`` and each branch of ``chunked_attention``
  within ``LAYER_RTOL`` of the largest value;
- the configs, the LM FLOP formulas, ``lm_batch``, ``threefry.fold_in`` /
  ``randint`` and the threefry twin's bits exactly; the serve entry
  point's token ids equal to the reference's.
"""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.data import lm_batch as ref_lm_batch
from repro.launch import serve as rserve
from repro.launch.steps import build_cell
from repro.models import layers as rl
from repro.models import transformer as rt
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.data import lm_batch
from repro_torch.launch import serve as pserve
from repro_torch.launch import steps as psteps
from repro_torch.models import layers as pl
from repro_torch.models import threefry
from repro_torch.models import transformer as pt

torch.set_num_threads(1)

LM_ARCHS = ("internlm2-1.8b", "command-r-plus-104b", "phi3-mini-3.8b",
            "llama4-maverick-400b-a17b", "kimi-k2-1t-a32b")
DENSE = ("internlm2-1.8b", "phi3-mini-3.8b", "command-r-plus-104b")
INIT_ATOL = 1e-6         # truncated normals (threefry.py: 7.2e-7 measured)
LAYER_RTOL = 1e-6        # rms_norm, RoPE, attention: of the largest value
FWD_RTOL = 1e-5          # logits, caches, losses: of the largest value
BF16_RTOL = 2e-2         # bfloat16 logits of the largest (2⁻⁸ a rounding)
B, S, GEN = 2, 40, 2     # prompts of 40 tokens: past SMOKE's chunk of 32
CPU = torch.device("cpu")


def rel_err(ref, out) -> float:
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out.detach().float().numpy() if isinstance(out, torch.Tensor)
                     else out, np.float64)
    return float(np.abs(ref - out).max() / max(np.abs(ref).max(), 1e-30))


def _t(a):
    return torch.from_numpy(np.array(a))


def _reference_run(cfg, params, prompts, follow):
    """forward (+cache), loss, and GEN decode steps from init_cache and
    from the padded prefill cache, feeding ``follow`` [B, GEN]."""
    logits, ex = rt.forward(cfg, params, prompts, return_cache=True)
    loss, aux = rt.loss_fn(cfg, params, jnp.concatenate([prompts, follow[:, :1]], 1))
    pad = ((0, 0), (0, 0), (0, GEN), (0, 0), (0, 0))
    caches = {"init": rt.init_cache(cfg, B, GEN),
              "prefill": dict(k=jnp.pad(ex["cache"]["k"], pad),
                              v=jnp.pad(ex["cache"]["v"], pad),
                              pos=jnp.full((B,), S, jnp.int32))}
    steps = {}
    for name, cache in caches.items():
        outs = []
        for i in range(GEN):
            lg, cache = rt.decode_step(cfg, params, cache, follow[:, i:i + 1])
            outs.append(lg)
        steps[name] = (jnp.concatenate(outs, 1), cache["k"], cache["pos"])
    return dict(logits=logits, aux=ex["aux_loss"], k=ex["cache"]["k"],
                v=ex["cache"]["v"], loss=loss, nll=aux["nll"], steps=steps)


@pytest.fixture(scope="module")
def runs():
    """Each dense SMOKE model: the reference's params and run (one jit),
    the same inputs for the port."""
    out = {}
    for arch in DENSE:
        cfg = ref_get_arch(arch).SMOKE
        params = jax.jit(rt.init_params, static_argnums=0)(cfg, jax.random.PRNGKey(0))
        prompts = ref_lm_batch(0, 1, B, S, cfg.vocab)
        follow = ref_lm_batch(0, 2, B, GEN, cfg.vocab)
        ref = jax.jit(_reference_run, static_argnums=0)(cfg, params, prompts, follow)
        out[arch] = (jax.tree.map(np.asarray, params), np.asarray(prompts),
                     np.asarray(follow), jax.tree.map(np.asarray, ref))
    return out


def _port_params(runs, arch):
    return interop.lm_params_from_jax(runs[arch][0], CPU)


# the reference's LMConfig fields that the port's lacks, each with the
# values under which the port computes what the reference does: compile
# and sharding knobs, and no biases
REF_ONLY_FIELDS = dict(attn_shard={"heads", "seq"},
                       moe_group_chunks={1}, scan_unroll={True, False},
                       attn_bias={False})


def test_configs_equal_reference():
    for arch in LM_ARCHS:
        a, b = ref_get_arch(arch), get_arch(arch)
        for name in ("CONFIG", "SMOKE"):
            ca, cb = getattr(a, name), getattr(b, name)
            ra, rb = dataclasses.asdict(ca), dataclasses.asdict(cb)
            assert {k: ra[k] for k in rb} == rb
            assert set(ra) - set(rb) == set(REF_ONLY_FIELDS)
            for k, ok in REF_ONLY_FIELDS.items():
                assert ra[k] in ok, (arch, name, k, ra[k])
            assert (ca.n_params, ca.n_active_params) == \
                (cb.n_params, cb.n_active_params)
        assert [dataclasses.asdict(c) for c in a.SHAPES] == \
            [dataclasses.asdict(c) for c in b.SHAPES]
        assert a.KIND == b.KIND == "lm"
        assert getattr(a, "OPTIMIZER", None) == getattr(b, "OPTIMIZER", None)
    assert get_arch("internlm2-1.8b").CONFIG.n_params == 1_889_110_016


def test_lm_flops_equal_reference():
    """Prefill and decode model FLOPs against the reference's cells."""
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    for arch in LM_ARCHS:
        cfg = get_arch(arch).CONFIG
        for shape, fn in (("prefill_32k", psteps.lm_prefill_flops),
                          ("decode_32k", psteps.lm_decode_flops)):
            cell = next(c for c in get_arch(arch).SHAPES if c.name == shape)
            plan = build_cell(arch, shape, mesh)
            assert fn(cfg, cell.global_batch, cell.seq_len) == plan.model_flops


@pytest.mark.parametrize("arch", DENSE)
def test_init_params_equal_reference(runs, arch):
    cfg = get_arch(arch).SMOKE
    port = interop.params_to_numpy(pt.init_params(cfg, threefry.prng_key(0), CPU))
    ref = runs[arch][0]
    assert jax.tree.structure(port) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(port)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_allclose(b, a, rtol=0, atol=INIT_ATOL)


def test_lm_params_from_jax_bit_for_bit():
    """float32 and bfloat16 trees cross and come back bit for bit, each
    leaf in its own dtype (norms and router float32)."""
    for arch, dt in (("internlm2-1.8b", "float32"),
                     ("internlm2-1.8b", "bfloat16"),
                     ("kimi-k2-1t-a32b", "bfloat16")):
        cfg = dataclasses.replace(ref_get_arch(arch).SMOKE, param_dtype=dt)
        ref = jax.tree.map(np.asarray, jax.jit(rt.init_params, static_argnums=0)(
            cfg, jax.random.PRNGKey(3)))
        port = interop.lm_params_from_jax(ref, CPU)
        for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(port)):
            assert str(b.dtype) == f"torch.{a.dtype.name}"
        back = interop.params_to_numpy(port)
        for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(back)):
            a = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
            assert a.dtype == b.dtype and np.array_equal(a, b)


def test_rms_norm_and_rope_equal_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 7, 3, 16)).astype(np.float32) * 3
    w = rng.normal(size=(16,)).astype(np.float32)
    assert rel_err(rl.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5),
                   pl.rms_norm(_t(x), _t(w), 1e-5)) <= LAYER_RTOL
    assert np.array_equal(pl.rope_freqs(96, 10000.0), rl.rope_freqs(96, 10000.0))
    pos = rng.integers(0, 4000, size=(2, 7)).astype(np.int32)
    assert rel_err(rl.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10000.0),
                   pl.apply_rope(_t(x), _t(pos), 10000.0)) <= LAYER_RTOL


ATTN_CASES = {
    # name: (Sq, Skv, H, Hkv, chunk, causal, masked kv)
    "one_block": (9, 9, 4, 4, 16, True, False),
    "streaming": (12, 32, 4, 2, 8, True, False),
    "padded_gqa": (20, 20, 6, 2, 8, True, True),
    "noncausal_valid": (1, 30, 4, 1, 8, False, True),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_chunked_attention_equal_reference(case):
    """Each branch: one block, whole chunks, padded chunks (GQA; a row of
    a batch whose valid keys all lie after it is wholly masked), and a
    decode-like query against a cache with ``kv_valid``."""
    Sq, Skv, H, Hkv, chunk, causal, masked = ATTN_CASES[case]
    rng = np.random.default_rng(len(case))
    q = rng.normal(size=(2, Sq, H, 8)).astype(np.float32)
    k = rng.normal(size=(2, Skv, Hkv, 8)).astype(np.float32)
    v = rng.normal(size=(2, Skv, Hkv, 8)).astype(np.float32)
    q_pos = np.broadcast_to(np.arange(Skv - Sq, Skv, dtype=np.int32), (2, Sq))
    kv_pos = np.broadcast_to(np.arange(Skv, dtype=np.int32), (2, Skv))
    valid = None
    if masked:
        valid = kv_pos < np.array([[Skv - 3], [Skv]])
        valid[0, : Skv // 2] = False       # batch 0: early rows see no key
    ref = rl.chunked_attention(*map(jnp.asarray, (q, k, v, q_pos, kv_pos)),
                               kv_valid=None if valid is None else jnp.asarray(valid),
                               chunk=chunk, causal=causal)
    out = pl.chunked_attention(*map(_t, (q, k, v, q_pos, kv_pos)),
                               kv_valid=None if valid is None else _t(valid),
                               chunk=chunk, causal=causal)
    assert out.shape == ref.shape and out.dtype == torch.float32
    assert rel_err(ref, out) <= LAYER_RTOL


@pytest.mark.parametrize("arch", DENSE)
def test_forward_and_loss_equal_reference(runs, arch):
    _, prompts, follow, ref = runs[arch]
    cfg = get_arch(arch).SMOKE
    params = _port_params(runs, arch)
    logits, ex = pt.forward(cfg, params, _t(prompts), return_cache=True)
    assert logits.shape == (B, S, cfg.vocab)
    assert rel_err(ref["logits"], logits) <= FWD_RTOL
    assert float(ex["aux_loss"]) == float(ref["aux"]) == 0.0
    for name in ("k", "v"):
        assert ex["cache"][name].shape == ref[name].shape
        assert rel_err(ref[name], ex["cache"][name]) <= FWD_RTOL
    loss, aux = pt.loss_fn(cfg, params, _t(np.concatenate([prompts, follow[:, :1]], 1)))
    assert abs(float(loss) - float(ref["loss"])) <= FWD_RTOL * abs(float(ref["loss"]))
    assert abs(float(aux["nll"]) - float(ref["nll"])) <= FWD_RTOL * float(ref["nll"])


@pytest.mark.parametrize("arch", DENSE)
@pytest.mark.parametrize("start", ["init", "prefill"])
def test_decode_step_equal_reference(runs, arch, start):
    """GEN decode steps from an empty cache, and from the prompt's
    prefill cache padded by GEN positions (serve.prefill)."""
    _, prompts, follow, ref = runs[arch]
    cfg = get_arch(arch).SMOKE
    params = _port_params(runs, arch)
    if start == "init":
        cache = pt.init_cache(cfg, B, GEN, device=CPU)
    else:
        _, cache = pserve.prefill(cfg, params, _t(prompts), S + GEN)
    outs = []
    for i in range(GEN):
        lg, cache = pt.decode_step(cfg, params, cache, _t(follow[:, i:i + 1]))
        outs.append(lg)
    r_logits, r_k, r_pos = ref["steps"][start]
    assert rel_err(r_logits, torch.cat(outs, 1)) <= FWD_RTOL
    assert rel_err(r_k, cache["k"]) <= FWD_RTOL
    assert np.array_equal(cache["pos"].numpy(), r_pos)


def test_bf16_internlm2_smoke_equal_reference():
    """internlm2 SMOKE with bfloat16 activations and weights: the
    reference's bf16 weights carried bit for bit, logits of a forward and
    of a decode step from its padded cache within BF16_RTOL."""
    bf16 = dict(dtype="bfloat16", param_dtype="bfloat16")
    cfg = dataclasses.replace(ref_get_arch("internlm2-1.8b").SMOKE, **bf16)
    params = jax.jit(rt.init_params, static_argnums=0)(cfg, jax.random.PRNGKey(0))
    prompts = ref_lm_batch(0, 1, B, S, cfg.vocab)
    follow = ref_lm_batch(0, 2, B, 1, cfg.vocab)

    @jax.jit
    def ref_run(p, t, f):
        logits, ex = rt.forward(cfg, p, t, return_cache=True)
        pad = ((0, 0), (0, 0), (0, 1), (0, 0), (0, 0))
        cache = dict(k=jnp.pad(ex["cache"]["k"], pad), v=jnp.pad(ex["cache"]["v"], pad),
                     pos=jnp.full((B,), S, jnp.int32))
        step, _ = rt.decode_step(cfg, p, cache, f)
        return logits.astype(jnp.float32), step.astype(jnp.float32)

    r_logits, r_step = ref_run(params, prompts, follow)
    pcfg = dataclasses.replace(get_arch("internlm2-1.8b").SMOKE, **bf16)
    pp = interop.lm_params_from_jax(jax.tree.map(np.asarray, params), CPU)
    logits, cache = pserve.prefill(pcfg, pp, _t(prompts), S + 1)
    assert logits.dtype == torch.bfloat16
    assert rel_err(r_logits, logits) <= BF16_RTOL
    step, _ = pt.decode_step(pcfg, pp, cache, _t(follow))
    assert rel_err(r_step, step) <= BF16_RTOL


LM_BATCHES = ((3, 0, 2, 17, 92544), (7, 12345, 3, 9, 10), (2**40 + 5, 3, 5, 8, 3),
              (11, 4, 8, 2000, 92544))


def test_lm_batch_bit_for_bit():
    ref_fn = jax.jit(ref_lm_batch, static_argnums=(0, 1, 2, 3, 4))
    for args in LM_BATCHES:
        ref = np.asarray(ref_fn(*args))
        out = lm_batch(*args, device=CPU)
        assert out.dtype == torch.int32
        assert np.array_equal(out.numpy(), ref), args


def test_fold_in_and_randint_bit_for_bit():
    for seed in (0, 1, 2**33 + 7):
        key = threefry.prng_key(seed)
        jkey = jax.random.PRNGKey(seed)
        for d in (0, 1, 99, 2**31 + 1, 2**32 - 1):
            assert np.array_equal(threefry.fold_in(key, d),
                                  np.asarray(jax.random.fold_in(jkey, d)))
        for lo, hi, shape in ((0, 10, (3, 4)), (1, 7, (6, 1)), (0, 2, (50,)),
                              (0, 92544, (4, 33)), (-5, 5, (40,)), (3, 3, (4,)),
                              (5, 2, (4,)), (0, 70000, (300,)),
                              (-2**31, 2**31 - 1, (64,))):
            ref = np.asarray(jax.random.randint(jkey, shape, lo, hi))
            out = threefry.randint(key, shape, lo, hi)
            assert out.dtype == np.int32
            assert np.array_equal(out, ref), (seed, lo, hi)


def test_torch_twin_equal_numpy(monkeypatch):
    """The device twin on the CPU: bits and uniforms exactly numpy's,
    truncated normals within INIT_ATOL of numpy's and of jax.random's,
    across chunk boundaries (chunks of 4,096 here)."""
    monkeypatch.setattr(threefry, "_CHUNK", 4096)
    key = threefry.prng_key(9)
    shape = (7, 1500)
    assert np.array_equal(threefry.torch_random_bits(key, shape, CPU).numpy(),
                          threefry.random_bits(key, shape).astype(np.int64))
    assert np.array_equal(threefry.torch_uniform(key, (999,), CPU, -0.5, 2).numpy(),
                          threefry.uniform(key, (999,), -0.5, 2))
    z = threefry.torch_truncated_normal(key, -2.0, 2.0, (300, 64), CPU).numpy()
    np.testing.assert_allclose(z, threefry.truncated_normal(key, -2.0, 2.0, (300, 64)),
                               rtol=0, atol=INIT_ATOL)
    ref = np.asarray(jax.random.truncated_normal(jax.random.PRNGKey(9), -2.0, 2.0,
                                                 (300, 64)))
    np.testing.assert_allclose(z, ref, rtol=0, atol=INIT_ATOL)


@pytest.mark.parametrize("arch,seed", [("internlm2-1.8b", 0), ("phi3-mini-3.8b", 5)])
def test_serve_main_equal_reference(arch, seed):
    argv = ["--arch", arch, "--smoke", "--batch", "2", "--prompt-len", "40",
            "--gen", "6", "--seed", str(seed)]
    outs = []
    for main, extra in ((rserve.main, []), (pserve.main, ["--device", "cpu"])):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            seqs = np.asarray(main(argv + extra))
        outs.append((seqs, buf.getvalue().splitlines()))
    (r_seqs, r_lines), (p_seqs, p_lines) = outs
    assert p_seqs.shape == (2, 6) and p_seqs.dtype == np.int32
    assert np.array_equal(p_seqs, r_seqs)
    assert p_lines[2] == r_lines[2]
    assert p_lines[2].startswith("sample continuation ids: ")
    assert p_lines[0].startswith("prefill: 2×40 in ")
    assert p_lines[1].startswith("decode: 5 steps × batch 2 in ")


def test_serve_main_keeps_what_it_served():
    """``main(keep=)`` hands back its config, weights, prompts and every
    step's logits: the tokens are their argmax, and each decode step's
    logits a forward's over the tokens so far."""
    keep = {}
    with contextlib.redirect_stdout(io.StringIO()):
        seqs = pserve.main(["--arch", "phi3-mini-3.8b", "--smoke", "--batch", "2",
                            "--prompt-len", "40", "--gen", "6", "--seed", "1",
                            "--device", "cpu"], keep=keep)
    cfg = get_arch("phi3-mini-3.8b").SMOKE
    assert keep["cfg"] == cfg and len(keep["logits"]) == 6
    assert torch.equal(keep["prompts"], lm_batch(1, 1, 2, 40, cfg.vocab, CPU))
    fresh = interop.params_to_numpy(
        pt.init_params(cfg, threefry.prng_key(1), CPU))
    kept = interop.params_to_numpy(keep["params"])
    assert jax.tree.structure(fresh) == jax.tree.structure(kept)
    for a, b in zip(jax.tree.leaves(fresh), jax.tree.leaves(kept)):
        assert np.array_equal(a, b)
    toks = torch.as_tensor(seqs)
    for i, lg in enumerate(keep["logits"]):
        assert lg.shape == (2, 1, cfg.vocab)
        assert torch.equal(pserve.greedy(lg[:, 0]), toks[:, i])
        ref, _ = pt.forward(cfg, keep["params"],
                            torch.cat([keep["prompts"], toks[:, :i]], 1))
        assert rel_err(ref[:, -1].numpy(), lg[:, 0]) <= FWD_RTOL
