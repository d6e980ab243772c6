"""The port's MoE layer and MoE LMs vs the JAX package's.

``moe_layer`` (its output and both aux losses) at the ``SMOKE`` widths of
llama4 (top-1 of 8 experts) and kimi (top-4 of 12), the reference's
weights carried across, within ``RTOL`` of the largest value; also a
router skewed so that assignments overflow the capacity (the same
tokens dropped), the groups in chunks (``group_chunks``), and exact ties
in the router (the lower expert index first, as ``lax.top_k``). Then the
two MoE SMOKE models' ``forward`` (logits, aux loss, cache) and
``decode_step`` from the padded prefill cache.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.data import lm_batch as ref_lm_batch
from repro.models import moe as rm
from repro.models import transformer as rt
from repro.models.layers import NO_RULES
from repro_torch import interop
from repro_torch.configs import get_arch
from repro_torch.launch import serve as pserve
from repro_torch.models import moe as pm
from repro_torch.models import transformer as pt

torch.set_num_threads(1)

MOE_ARCHS = ("llama4-maverick-400b-a17b", "kimi-k2-1t-a32b")
RTOL = 1e-5              # of the largest value
T = 128                  # tokens: four dispatch groups of 32
B, S, GEN = 2, 48, 2     # the models' prompts (B·S a multiple of 32)
CPU = torch.device("cpu")


def rel_err(ref, out) -> float:
    ref = np.asarray(ref, np.float64)
    out = out.detach().double().numpy()
    return float(np.abs(ref - out).max() / max(np.abs(ref).max(), 1e-30))


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def layers():
    """Each MoE SMOKE spec: layer 0's reference weights and tokens."""
    out = {}
    for arch in MOE_ARCHS:
        cfg = ref_get_arch(arch).SMOKE
        p = rm.init_moe_params(jax.random.PRNGKey(1), cfg.d_model, cfg.moe, 1,
                               jnp.float32)
        p = {k: np.asarray(v[0]) for k, v in p.items()}
        x = np.random.default_rng(0).normal(size=(T, cfg.d_model)).astype(np.float32)
        out[arch] = (cfg.moe, p, x)
    return out


def _both(spec, p, x):
    """The reference's and the port's moe_layer on the same inputs."""
    ry, raux = jax.jit(lambda p, x: rm.moe_layer(x, p, spec, NO_RULES))(
        {k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    py, paux = pm.moe_layer(_t(x), {k: _t(v) for k, v in p.items()}, spec)
    return (np.asarray(ry), raux), (py, paux)


def _check(ref, port):
    (ry, raux), (py, paux) = ref, port
    assert py.shape == ry.shape and py.dtype == torch.float32
    assert rel_err(ry, py) <= RTOL
    for k in ("load_balance", "router_z"):
        assert abs(float(paux[k]) - float(raux[k])) <= RTOL * abs(float(raux[k]))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_layer_equal_reference(layers, arch):
    spec, p, x = layers[arch]
    _check(*_both(spec, p, x))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_capacity_overflow_drops_the_same_tokens(layers, arch):
    """A router that sends most tokens to expert 0 first: past the
    capacity their assignments are dropped, in both packages alike."""
    spec, p, x = layers[arch]
    p = dict(p, router=p["router"].copy())
    p["router"][:, 0] += 0.5 * np.sign(x.sum(0))
    ref, port = _both(spec, p, x)
    _check(ref, port)
    # top-1: a dropped token's output is zero; some are, in both alike
    ry, py = ref[0], port[0].numpy()
    if spec.top_k == 1:
        zero = ~ry.any(1)
        assert zero.sum() > 0 and np.array_equal(zero, ~py.any(1))
    probs = jax.nn.softmax(jnp.asarray(x) @ p["router"], -1)
    top = np.asarray(jax.lax.top_k(probs, spec.top_k)[1])
    C = pm._capacity(min(spec.group_size, T), spec)
    assert np.bincount(top[:32].ravel(), minlength=spec.n_experts).max() > C


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_group_chunks_equal_reference(layers, arch):
    spec, p, x = layers[arch]
    spec = dataclasses.replace(spec, group_chunks=2)
    ref, port = _both(spec, p, x)
    _check(ref, port)
    # chunked == whole, in the port
    y1, _ = pm.moe_layer(_t(x), {k: _t(v) for k, v in p.items()},
                         dataclasses.replace(spec, group_chunks=1))
    assert torch.equal(port[0], y1)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_router_ties_choose_lower_experts(layers, arch):
    """A router of zeros: every probability ties, so the first top_k
    experts are chosen for every token and the queues overflow."""
    spec, p, x = layers[arch]
    p = dict(p, router=np.zeros_like(p["router"]))
    ref, port = _both(spec, p, x)
    _check(ref, port)
    probs = torch.softmax(_t(x) @ _t(p["router"]), -1)
    _, eidx = torch.sort(probs, dim=-1, descending=True, stable=True)
    assert (eidx[:, :spec.top_k] == torch.arange(spec.top_k)).all()


@pytest.fixture(scope="module")
def models():
    """Each MoE SMOKE model: the reference's params, prompts, and one
    jitted run (forward with the cache, GEN decode steps after it)."""
    out = {}
    for arch in MOE_ARCHS:
        cfg = ref_get_arch(arch).SMOKE
        params = jax.jit(rt.init_params, static_argnums=0)(cfg, jax.random.PRNGKey(0))
        prompts = ref_lm_batch(0, 1, B, S, cfg.vocab)
        follow = ref_lm_batch(0, 2, B, GEN, cfg.vocab)

        @jax.jit
        def run(params, prompts, follow, cfg=cfg):
            logits, ex = rt.forward(cfg, params, prompts, return_cache=True)
            pad = ((0, 0), (0, 0), (0, GEN), (0, 0), (0, 0))
            cache = dict(k=jnp.pad(ex["cache"]["k"], pad),
                         v=jnp.pad(ex["cache"]["v"], pad),
                         pos=jnp.full((B,), S, jnp.int32))
            steps = []
            for i in range(GEN):
                lg, cache = rt.decode_step(cfg, params, cache, follow[:, i:i + 1])
                steps.append(lg)
            return logits, ex, jnp.concatenate(steps, 1)

        ref = run(params, prompts, follow)
        out[arch] = (jax.tree.map(np.asarray, params), np.asarray(prompts),
                     np.asarray(follow), jax.tree.map(np.asarray, ref))
    return out


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_model_forward_equal_reference(models, arch):
    params, prompts, _, (r_logits, r_ex, _) = models[arch]
    cfg = get_arch(arch).SMOKE
    pp = interop.lm_params_from_jax(params, CPU)
    logits, ex = pt.forward(cfg, pp, _t(prompts), return_cache=True)
    assert rel_err(r_logits, logits) <= RTOL
    aux = float(r_ex["aux_loss"])
    assert aux > 0 and abs(float(ex["aux_loss"]) - aux) <= RTOL * aux
    for k in ("k", "v"):
        assert rel_err(r_ex["cache"][k], ex["cache"][k]) <= RTOL


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_model_decode_step_equal_reference(models, arch):
    params, prompts, follow, (_, _, r_steps) = models[arch]
    cfg = get_arch(arch).SMOKE
    pp = interop.lm_params_from_jax(params, CPU)
    _, cache = pserve.prefill(cfg, pp, _t(prompts), S + GEN)
    steps = []
    for i in range(GEN):
        lg, cache = pt.decode_step(cfg, pp, cache, _t(follow[:, i:i + 1]))
        steps.append(lg)
    assert rel_err(r_steps, torch.cat(steps, 1)) <= RTOL
