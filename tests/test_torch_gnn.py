"""The port's GNN substrate and SchNet vs the JAX package's.

Every function of ``repro_torch.models.gnn.common`` on the same seeded
inputs as ``repro.models.gnn.common``: ``build_triplets`` bit for bit,
the float functions within ``RTOL`` / ``ATOL`` (float32 rounding: the
matrix products, reductions and ``exp`` are other code); SchNet's forward
at the ``SMOKE`` widths under the reference's weights carried across,
within ``FWD_RTOL`` (segment sums add in another order); the numpy
threefry draws the reference's keys, bits and uniforms exactly and its
truncated normals within float32 rounding."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.models.gnn import common as rc
from repro.models.gnn import schnet as rs
from repro.models.layers import truncated_normal as ref_truncated_normal
from repro_torch import interop
from repro_torch.configs import get_arch, list_archs
from repro_torch.models import threefry
from repro_torch.models.gnn import common as pc
from repro_torch.models.gnn import schnet as ps
from repro_torch.models.layers import truncated_normal

torch.set_num_threads(1)

RTOL, ATOL = 1e-6, 2e-6        # the float functions of common.py
FWD_RTOL, FWD_ATOL = 1e-5, 1e-6  # SchNet's forward
CPU = torch.device("cpu")


def _t(x):
    return None if x is None else torch.as_tensor(np.array(x))


def to_port(g) -> pc.GraphBatch:
    return pc.GraphBatch(**{f.name: (_t(getattr(g, f.name))
                                     if f.name != "n_graphs" else g.n_graphs)
                            for f in dataclasses.fields(pc.GraphBatch)})


def close(a, b, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(b.detach().numpy()), np.asarray(a),
                               rtol=rtol, atol=atol)


@pytest.fixture(scope="module")
def graph():
    """tests/test_models_gnn.py's graph: 24 nodes in a box, radius 3,
    128 edge slots (some padding), two graphs."""
    g = rc.radius_graph_batch(jax.random.PRNGKey(0), n_nodes=24, cutoff=3.0,
                              box=6.0, e_cap=128, n_graphs=2)
    return g, to_port(g)


@pytest.fixture(scope="module")
def smoke():
    c = ref_get_arch("schnet").SMOKE
    kw = dict(n_interactions=c.n_layers, d_hidden=c.d_hidden,
              n_rbf=c.extras["n_rbf"], cutoff=c.extras["cutoff"])
    return kw


def test_segment_mp_equal_reference(graph):
    g, _ = graph
    msg = np.random.default_rng(0).normal(size=(128, 5)).astype(np.float32)
    for valid in (None, g.edge_valid):
        ref = rc.segment_mp(jnp.asarray(msg), g.edge_dst, 24, valid)
        out = pc.segment_mp(torch.tensor(msg), _t(g.edge_dst), 24, _t(valid))
        close(ref, out)


def test_segment_softmax_equal_reference(graph):
    g, _ = graph
    sc = np.random.default_rng(1).normal(size=(128, 3)).astype(np.float32) * 4
    for valid in (None, g.edge_valid):
        ref = rc.segment_softmax(jnp.asarray(sc), g.edge_dst, 24, valid)
        out = pc.segment_softmax(torch.tensor(sc), _t(g.edge_dst), 24, _t(valid))
        close(ref, out)


def test_edge_vectors_equal_reference(graph):
    g, gp = graph
    for a, b in zip(rc.edge_vectors(g), pc.edge_vectors(gp)):
        close(a, b)


@pytest.mark.parametrize("fn,args", [
    ("gaussian_rbf", (300, 10.0)), ("gaussian_rbf", (32, 3.0)),
    ("bessel_rbf", (16, 3.0)), ("cosine_cutoff", (3.0,)),
    ("polynomial_cutoff", (3.0,)), ("shifted_softplus", ()),
])
def test_float_functions_equal_reference(fn, args):
    """On distances from 0 past the cutoff (and negatives for the
    softplus), seeded."""
    rng = np.random.default_rng(2)
    d = np.concatenate([[0.0, 1e-7, 3.0, 10.0],
                        rng.uniform(0, 12, 400)]).astype(np.float32)
    if fn == "shifted_softplus":
        d = np.concatenate([d, -d, [30.0, -30.0]]).astype(np.float32)
    ref = getattr(rc, fn)(jnp.asarray(d), *args)
    close(ref, getattr(pc, fn)(torch.tensor(d), *args))


def test_shifted_softplus_gradient_equal_reference():
    x = np.linspace(-25, 25, 501).astype(np.float32)
    ref = jax.grad(lambda v: rc.shifted_softplus(v).sum())(jnp.asarray(x))
    t = torch.tensor(x, requires_grad=True)
    pc.shifted_softplus(t).sum().backward()
    close(ref, t.grad)


def test_build_triplets_bit_for_bit(graph):
    g, _ = graph
    src, dst = np.asarray(g.edge_src), np.asarray(g.edge_dst)
    for cap in (None, 4096):
        for a, b in zip(rc.build_triplets(src, dst, 24, cap),
                        pc.build_triplets(src, dst, 24, cap)):
            assert a.dtype == b.dtype and np.array_equal(a, b)
    with pytest.raises(ValueError, match="triplet overflow"):
        pc.build_triplets(src, dst, 24, 3)


def test_random_graph_batch_matches_reference_in_kind():
    """Shapes, dtypes and value ranges (the draws are torch's, not
    jax.random's)."""
    ref = rc.random_graph_batch(jax.random.PRNGKey(3), 40, 200, d_feat=4,
                                n_species=5, n_graphs=3)
    out = pc.random_graph_batch(torch.Generator().manual_seed(3), 40, 200,
                                d_feat=4, n_species=5, n_graphs=3, device="cpu")
    for f in dataclasses.fields(pc.GraphBatch):
        a, b = getattr(ref, f.name), getattr(out, f.name)
        if f.name == "n_graphs":
            assert a == b
            continue
        assert tuple(a.shape) == tuple(b.shape), f.name
        assert np.asarray(a).dtype == b.numpy().dtype, f.name
    assert bool((out.edge_src != out.edge_dst).all())
    assert 0 <= float(out.positions.min()) and float(out.positions.max()) < 8.0
    assert int(out.species.max()) < 5 and int(out.edge_dst.max()) < 40
    assert np.array_equal(np.asarray(ref.graph_id), out.graph_id.numpy())


def test_radius_graph_batch_matches_reference_in_kind():
    ref = rc.radius_graph_batch(jax.random.PRNGKey(0), 24, 3.0, 6.0, 128, 2)
    out = pc.radius_graph_batch(torch.Generator().manual_seed(0), 24, 3.0, 6.0,
                                128, 2, device="cpu")
    for f in ("species", "node_valid", "graph_id"):      # host numpy draws
        assert np.array_equal(np.asarray(getattr(ref, f)),
                              getattr(out, f).numpy()), f
    ev = out.edge_valid.numpy()
    d = pc.edge_vectors(out)[1].numpy()
    assert ev.shape == (128,) and ((d[ev] < 3.0) & (d[ev] > 0)).all()
    assert out.positions.dtype == torch.float32
    if not torch.cuda.is_available():          # no CPU fallback by default
        with pytest.raises(RuntimeError, match="CUDA"):
            pc.radius_graph_batch(torch.Generator(), 4, 1.0, 1.0, 8)


def _carried(key, cfg_kw, **io):
    cfg_r, cfg_p = rs.Cfg(**cfg_kw, **io), ps.Cfg(**cfg_kw, **io)
    p = rs.init_params(key, cfg_r)
    model = ps.SchNet(cfg_p, device=CPU)
    model.load_state_dict(interop.schnet_params_from_jax(
        jax.tree.map(np.asarray, p), CPU))
    return cfg_r, p, model


def _published():
    c = ref_get_arch("schnet").CONFIG
    return dict(n_interactions=c.n_layers, d_hidden=c.d_hidden,
                n_rbf=c.extras["n_rbf"], cutoff=c.extras["cutoff"])


@pytest.mark.parametrize("inputs", ["species", "node_feat", "published"])
def test_schnet_forward_equal_reference(graph, smoke, inputs):
    """At SMOKE widths with species and with node features; at CONFIG's
    published widths (3 interactions, 64 wide, 300 bases, cutoff 10) with
    the downstream example's 3 node features and two classes, the model
    ``chip_smoke.py``'s path i trains."""
    g, gp = graph
    widths, io = smoke, {}
    if inputs != "species":
        widths, d_feat, d_out = ((smoke, 6, 3) if inputs == "node_feat"
                                 else (_published(), 3, 2))
        feat = np.random.default_rng(4).normal(
            size=(24, d_feat)).astype(np.float32)
        g = dataclasses.replace(g, node_feat=jnp.asarray(feat), species=None)
        gp = dataclasses.replace(gp, node_feat=torch.tensor(feat), species=None)
        io = dict(d_feat=d_feat, d_out=d_out)
    cfg_r, p, model = _carried(jax.random.PRNGKey(1), widths, **io)
    node_r, graph_r = rs.forward(cfg_r, p, g)
    with torch.no_grad():
        node_p, graph_p = model(gp)
    assert tuple(node_p.shape) == node_r.shape
    close(node_r, node_p, FWD_RTOL, FWD_ATOL)
    close(graph_r, graph_p, FWD_RTOL, FWD_ATOL)


def test_schnet_rotation_and_translation_invariance(graph):
    """tests/test_models_gnn.py's check: SchNet depends on distances only."""
    _, gp = graph
    cfg = ps.Cfg(n_interactions=3, d_hidden=64, n_rbf=32, cutoff=3.0)
    model = ps.SchNet(cfg, key=threefry.prng_key(1), device=CPU)
    rng = np.random.default_rng(0)
    a, b, c = rng.uniform(0, 2 * np.pi, 3)
    Rz = lambda t: np.array([[np.cos(t), -np.sin(t), 0],
                             [np.sin(t), np.cos(t), 0], [0, 0, 1]])
    Ry = lambda t: np.array([[np.cos(t), 0, np.sin(t)], [0, 1, 0],
                             [-np.sin(t), 0, np.cos(t)]])
    R = torch.tensor(Rz(a) @ Ry(b) @ Rz(c), dtype=torch.float32)
    moved = dataclasses.replace(gp, positions=gp.positions @ R.T
                                + torch.tensor([1.5, -2.0, 0.25]))
    with torch.no_grad():
        node, g_out = model(gp)
        node_m, _ = model(moved)
    assert tuple(node.shape) == (24, 1) and tuple(g_out.shape) == (2, 1)
    assert bool(torch.isfinite(node).all())
    np.testing.assert_allclose(node.numpy(), node_m.numpy(), atol=1e-4)


def test_schnet_names_mirror_the_reference_tree(smoke):
    cfg_r, p, model = _carried(jax.random.PRNGKey(2), smoke)
    names = set(model.state_dict())
    assert {"embed.w", "blocks.1.w_out2.b", "head2.w"} <= names
    assert "embed.b" not in names                       # species: w alone
    ref = jax.tree.map(np.asarray, p)
    back = interop.params_to_numpy(model)
    assert jax.tree.structure(ref) == jax.tree.structure(back)
    for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_init_params_from_threefry_key_equal_reference(smoke):
    """The reference's weights, drawn without JAX: within float32
    rounding of the inverse error function."""
    for io in ({}, dict(d_feat=3, d_out=2)):
        ref = jax.tree.map(np.asarray, rs.init_params(
            jax.random.PRNGKey(0), rs.Cfg(**smoke, **io)))
        out = interop.params_to_numpy(ps.init_params(
            threefry.prng_key(0), ps.Cfg(**smoke, **io)))
        assert jax.tree.structure(ref) == jax.tree.structure(out)
        for a, b in zip(jax.tree.leaves(ref), jax.tree.leaves(out)):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6)


def test_threefry_equal_jax_random():
    k = jax.random.PRNGKey(42)
    kp = threefry.prng_key(42)
    assert np.array_equal(np.asarray(k), kp)
    ks, kps = jax.random.split(k, 7), threefry.split(kp, 7)
    assert np.array_equal(np.asarray(ks), kps)
    assert np.array_equal(np.asarray(jax.random.bits(ks[3], (5, 9))),
                          threefry.random_bits(kps[3], (5, 9)))
    assert np.array_equal(np.asarray(jax.random.uniform(ks[4], (301,))),
                          threefry.uniform(kps[4], (301,)))
    tn = threefry.truncated_normal(kps[5], -2.0, 2.0, (64, 33))
    np.testing.assert_allclose(
        tn, np.asarray(jax.random.truncated_normal(ks[5], -2.0, 2.0, (64, 33))),
        rtol=0, atol=1e-6)
    assert tn.dtype == np.float32 and -2 < tn.min() and tn.max() < 2


def test_truncated_normal_equal_reference_layer():
    ref = np.asarray(ref_truncated_normal(jax.random.PRNGKey(7), (300, 64),
                                          1 / np.sqrt(300), jnp.float32))
    z = truncated_normal(threefry.prng_key(7), (300, 64), 1 / np.sqrt(300))
    assert z.dtype == torch.float32 and tuple(z.shape) == (300, 64)
    np.testing.assert_allclose(z.numpy(), ref, rtol=0, atol=1e-6)


def test_schnet_default_weights_are_prng_key_0(smoke):
    cfg = ps.Cfg(**smoke, d_feat=3, d_out=2)
    a = interop.params_to_numpy(ps.SchNet(cfg, device=CPU))
    b = interop.params_to_numpy(ps.init_params(threefry.prng_key(0), cfg))
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert np.array_equal(x, y)


def test_configs_equal_reference():
    assert list_archs() == ["internlm2-1.8b", "command-r-plus-104b",
                            "phi3-mini-3.8b", "llama4-maverick-400b-a17b",
                            "kimi-k2-1t-a32b", "nequip", "schnet", "dimenet",
                            "equiformer-v2", "bst", "tripoll"]
    assert _published() == dict(n_interactions=3, d_hidden=64, n_rbf=300,
                                cutoff=10.0)
    for which in ("CONFIG", "SMOKE"):
        a = getattr(ref_get_arch("schnet"), which)
        b = getattr(get_arch("schnet"), which)
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert [dataclasses.asdict(c) for c in ref_get_arch("schnet").SHAPES] == \
        [dataclasses.asdict(c) for c in get_arch("schnet").SHAPES]
    assert get_arch("schnet").KIND == "gnn"
    for arch in ("no-such-arch", "nope"):
        with pytest.raises(KeyError, match=f"unknown arch '{arch}'"):
            get_arch(arch)
        with pytest.raises(KeyError, match=f"unknown arch '{arch}'"):
            ref_get_arch(arch)
