"""The port's optimizers, trainer and int8 compressor vs the JAX package's.

The same parameter tree (SchNet's at the ``SMOKE`` widths, carried
across as numpy) and the same seeded gradients go through three steps
of each optimizer in both packages; parameters and state agree within
``RTOL`` / ``ATOL`` (float32 rounding of ``sqrt``/``pow`` and the
sums). The int8 compressor's quantized bytes, scales and error-feedback
residuals are equal bit for bit: its arithmetic is elementwise float32
and ``torch.round`` rounds half to even as ``jnp.round`` does. Three
AdamW steps of SchNet itself, gradients from autograd against
``jax.value_and_grad``, end within ``SCHNET_ATOL``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.comm import collectives as rcol
from repro.configs import get_arch as ref_get_arch
from repro.models.gnn import common as rc
from repro.models.gnn import schnet as rs
from repro.train import optimizer as ropt
from repro.train import trainer as rtr
from repro_torch import interop
from repro_torch.comm import collectives as pcol
from repro_torch.models.gnn import schnet as ps
from repro_torch.train import optimizer as popt
from repro_torch.train import trainer as ptr
from test_torch_gnn import close, to_port

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6          # optimizer steps on the same gradients
SCHNET_ATOL = 2e-6               # SchNet's parameters after three AdamW steps


def tt(tree):
    """A numpy tree as torch tensors (copies)."""
    if isinstance(tree, dict):
        return {k: tt(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tt(v) for v in tree)
    return torch.tensor(np.array(tree))


def as_np(tree):
    return jax.tree.map(np.asarray, tree)


def tree_close(ref, out, rtol=RTOL, atol=ATOL):
    ref = as_np(ref)
    out = jax.tree.map(lambda t: t.detach().numpy(), out)
    assert jax.tree.structure(ref) == jax.tree.structure(out)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(out)):
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def smoke():
    c = ref_get_arch("schnet").SMOKE
    return dict(n_interactions=c.n_layers, d_hidden=c.d_hidden,
                n_rbf=c.extras["n_rbf"], cutoff=c.extras["cutoff"])


@pytest.fixture(scope="module")
def tree(smoke):
    """SchNet's SMOKE tree and three seeded gradient trees, as numpy."""
    p = as_np(rs.init_params(jax.random.PRNGKey(5), rs.Cfg(**smoke, d_feat=3)))
    rng = np.random.default_rng(7)
    grads = [jax.tree.map(lambda a, s=s: (rng.normal(size=a.shape) * s)
                          .astype(np.float32), p) for s in (0.1, 0.01, 3.0)]
    return p, grads


@pytest.mark.parametrize("name,kw", [
    ("adamw", dict(lr=1e-2)),
    ("adamw", dict(lr=1e-2, weight_decay=0.1, clip_norm=None)),
    ("adafactor", dict(lr=1e-2, weight_decay=0.01)),
    ("sgd_momentum", dict(lr=1e-2)),
])
def test_three_optimizer_steps_equal_reference(tree, name, kw):
    p, grads = tree
    r, o = getattr(ropt, name)(**kw), getattr(popt, name)(**kw)
    rp, rs_ = p, r.init(p)
    pp, ps_ = tt(p), o.init(tt(p))
    r_update = jax.jit(r.update)
    for g in grads:
        rp, rs_ = r_update(g, rs_, rp)
        pp, ps_ = o.update(tt(g), ps_, pp)
    tree_close(rp, pp)
    assert int(ps_["step"]) == int(rs_["step"]) == 3
    ref_state = {k: v for k, v in as_np(rs_).items() if k != "step"}
    out_state = {k: v for k, v in ps_.items() if k != "step"}
    tree_close(ref_state, out_state)


def test_global_norm_and_cosine_schedule_equal_reference(tree):
    _, grads = tree
    for g in grads:
        np.testing.assert_allclose(float(popt.global_norm(tt(g))),
                                   float(ropt.global_norm(g)), rtol=1e-6)
    r, o = ropt.cosine_schedule(3e-4, 10, 100), popt.cosine_schedule(3e-4, 10, 100)
    for s in (0, 1, 9, 10, 11, 55, 99, 100, 150):
        np.testing.assert_allclose(float(o(s)), float(r(s)), rtol=1e-6)


def test_int8_quantize_bit_for_bit():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(257, 33)).astype(np.float32)
    x[0, :4] = [0.5, -0.5, 1.5, 2.5]          # ties after scaling, too
    for arr in (x, x * 1e-8, np.zeros(5, np.float32),
                (np.arange(-254, 255) / 2).astype(np.float32)):
        qr, sr = rcol.int8_quantize(jnp.asarray(arr))
        qp, sp = pcol.int8_quantize(torch.tensor(arr))
        assert qp.dtype == torch.int8
        assert np.array_equal(np.asarray(qr), qp.numpy())
        assert np.asarray(sr).tobytes() == sp.numpy().tobytes()
        assert np.asarray(rcol.int8_dequantize(qr, sr)).tobytes() == \
            pcol.int8_dequantize(qp, sp).numpy().tobytes()


def test_int8_compressor_error_feedback_bit_for_bit(tree):
    p, grads = tree
    rt, pt = rcol.make_int8_compressor(), pcol.make_int8_compressor()
    ref_ef = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), p)
    out_ef = tt(ref_ef)
    for g in grads:
        rg, ref_ef = rt(g, ref_ef)
        pg, out_ef = pt(tt(g), out_ef)
        for a, b in zip(jax.tree.leaves(as_np((rg, ref_ef))),
                        jax.tree.leaves(interop.params_to_numpy((pg, out_ef)))):
            assert a.tobytes() == b.tobytes()
    assert pcol.compressed_bytes(tt(p)) == rcol.compressed_bytes(p)


def _linear_loss_pair():
    def ref_loss(params, batch):
        x, y = batch
        pred = x @ params["w"] + params["b"]
        return jnp.mean((pred - y) ** 2), {"n": jnp.float32(x.shape[0])}

    def port_loss(params, batch):
        x, y = batch
        pred = x @ params["w"] + params["b"]
        return torch.mean((pred - y) ** 2), {"n": x.shape[0]}
    return ref_loss, port_loss


@pytest.mark.parametrize("accum,compress", [(1, False), (2, False), (2, True)])
def test_make_train_step_equal_reference(accum, compress):
    """Microbatches summed in float32 in order and divided by
    ``accum_steps``; the int8 compressor as the gradient transform."""
    rng = np.random.default_rng(3)
    params = dict(w=rng.normal(size=(6, 2)).astype(np.float32),
                  b=np.zeros(2, np.float32))
    shape = (accum, 16) if accum > 1 else (16,)
    batches = [(rng.normal(size=shape + (6,)).astype(np.float32),
                rng.normal(size=shape + (2,)).astype(np.float32))
               for _ in range(3)]
    ref_loss, port_loss = _linear_loss_pair()
    kw = dict(accum_steps=accum)
    if compress:
        kw["grad_transform"] = rcol.make_int8_compressor()
    r_step = jax.jit(rtr.make_train_step(ref_loss, ropt.adamw(1e-2), **kw))
    if compress:
        kw["grad_transform"] = pcol.make_int8_compressor()
    p_step = ptr.make_train_step(port_loss, popt.adamw(1e-2), **kw)
    r_state = rtr.init_state(params, ropt.adamw(1e-2), compression=compress)
    p_state = ptr.init_state(tt(params), popt.adamw(1e-2), compression=compress)
    for b in batches:
        r_state, rm = r_step(r_state, b)
        p_state, pm = p_step(p_state, tuple(torch.tensor(x) for x in b))
        np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                                   rtol=1e-6)
        np.testing.assert_allclose(float(pm["grad_norm"]),
                                   float(rm["grad_norm"]), rtol=1e-5)
        assert set(pm) == set(rm)
    tree_close(r_state.params, p_state.params)
    assert int(p_state.step) == int(r_state.step) == 3
    if compress:
        tree_close(r_state.ef, p_state.ef)
    else:
        assert p_state.ef is None


def test_three_adamw_steps_of_schnet_equal_reference(smoke):
    """SchNet at SMOKE widths on tests/test_models_gnn.py's graph, node
    targets, the reference's weights carried across: three AdamW steps
    with autograd against jax.value_and_grad."""
    g = rc.radius_graph_batch(jax.random.PRNGKey(0), n_nodes=24, cutoff=3.0,
                              box=6.0, e_cap=128, n_graphs=2)
    gp = to_port(g)
    y = np.random.default_rng(9).normal(size=(24, 1)).astype(np.float32)
    cfg_r, cfg_p = rs.Cfg(**smoke), ps.Cfg(**smoke)
    p = rs.init_params(jax.random.PRNGKey(6), cfg_r)

    def ref_loss(params, b):
        node, graph = rs.forward(cfg_r, params, b)
        return jnp.mean((node - y) ** 2) + jnp.mean(graph ** 2), {}

    yt = torch.tensor(y)

    def port_loss(params, b):
        node, graph = ps.forward(cfg_p, params, b)
        return torch.mean((node - yt) ** 2) + torch.mean(graph ** 2), {}

    r_step = jax.jit(rtr.make_train_step(ref_loss, ropt.adamw(1e-3)))
    p_step = ptr.make_train_step(port_loss, popt.adamw(1e-3))
    r_state = rtr.init_state(p, ropt.adamw(1e-3))
    model = ps.SchNet(cfg_p, device="cpu")
    model.load_state_dict(interop.schnet_params_from_jax(as_np(p), "cpu"))
    p_state = ptr.init_state(
        popt.tree_map(lambda t: t.detach().clone(), model.tree()),
        popt.adamw(1e-3))
    for _ in range(3):
        r_state, rm = r_step(r_state, g)
        p_state, pm = p_step(p_state, gp)
        np.testing.assert_allclose(float(pm["loss"]), float(rm["loss"]),
                                   rtol=1e-5)
    tree_close(r_state.params, p_state.params, rtol=0, atol=SCHNET_ATOL)
    tree_close(r_state.opt_state["m"], p_state.opt_state["m"], rtol=1e-4,
               atol=1e-7)
    with torch.no_grad():
        node_p, _ = ps.forward(cfg_p, p_state.params, gp)
    close(rs.forward(cfg_r, r_state.params, g)[0], node_p, 1e-4, 1e-5)
