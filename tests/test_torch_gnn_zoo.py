"""The port's DimeNet, NequIP and EquiformerV2 vs the JAX package's.

Each model at its ``SMOKE`` widths, on tests/test_models_gnn.py's graph
(24 nodes, 128 edge slots, two graphs) and on the same positions with
512 slots (158 real edges, the rest padding 0→0):

- ``init_params`` from a threefry key equal to ``jax.random``'s within
  ``INIT_ATOL`` (the truncated normal's float32 rounding), under the
  reference's names;
- forward node and graph outputs within ``FWD_RTOL`` of the reference's
  (the reference's weights carried across);
- parameter gradients of the energy loss (``launch.steps.gnn_loss``)
  within ``GRAD_RTOL`` of each leaf's and ``GRAD_ATOL`` of the largest
  gradient (EquiformerV2's attention bias ``alpha.b`` has a gradient of
  exactly 0 in exact arithmetic — the segment softmax is invariant to it
  — so both packages give rounding noise there);
- three AdamW(1e-3) steps through the port's ``make_train_step`` against
  the reference's optimizer on its gradients: losses within 1e-4,
  parameters within ``ADAM_ATOL`` (AdamW turns ``alpha.b``'s noise into
  steps of ±lr, so that leaf is held to moving at most 3 lr in both).

One jitted reference function a model and graph gives its outputs,
gradients and AdamW update. Also: EquiformerV2's streaming attention
(``edge_chunks``) equal to the whole-edge softmax, the Bessel basis on
tensors against the host's float64 recursion and its roots, the configs
and the GNN cells of ``launch.steps``.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.launch import steps as rsteps
from repro.models.gnn import common as rc
from repro.models.gnn import dimenet as rd
from repro.train import optimizer as ropt
from repro_torch import interop
from repro_torch.configs import get_arch, list_archs
from repro_torch.launch import steps as psteps
from repro_torch.models import threefry
from repro_torch.models.gnn import dimenet as pd
from repro_torch.train import optimizer as popt
from repro_torch.train import trainer as ptr
from test_torch_gnn import to_port

torch.set_num_threads(1)

# the dimenet Bessel host path must be warning-free, as in
# tests/test_models_gnn.py
pytestmark = pytest.mark.filterwarnings("error::RuntimeWarning")

INIT_ATOL = 7.2e-7               # truncated normals (threefry.py)
FWD_RTOL = 1e-5                  # node and graph outputs, of the largest
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-5   # of each element; of the largest gradient
# parameters after three AdamW(1e-3) steps: AdamW divides by |g|, so an
# element whose gradient is near 0 moves by its rounding (measured: 3.1e-6
# at most, DimeNet, one element of blocks.1.mlp2.w and of blocks.1.msg_dn.w)
ADAM_ATOL = 1e-5
# j_l on float32 tensors vs the reference's: near x = π, j₀'s root, the
# Miller scale (sin x / x) / jc cancels; both sit ~8e-6 from the float64
# value there and 4.8e-6 apart (elsewhere 1.2e-7)
BESSEL_ATOL = 1e-5
LR = 1e-3
ARCHS = ("dimenet", "nequip", "equiformer-v2")
MODULES = {"dimenet": "DimeNet", "nequip": "NequIP",
           "equiformer-v2": "EquiformerV2"}
GRAPHS = ("radius", "padded")
CPU = torch.device("cpu")


def as_np(tree):
    return jax.tree.map(np.asarray, tree)


def leaves_with_paths(tree):
    return [(jax.tree_util.keystr(k), np.asarray(v)) for k, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]]


def port_np(tree):
    return interop.params_to_numpy(tree)


@pytest.fixture(scope="module")
def graphs():
    """name → (reference GraphBatch, port GraphBatch, DimeNet triplets of
    each, energy labels)."""
    out = {}
    for name, kw in (("radius", dict(e_cap=128, n_graphs=2)),
                     ("padded", dict(e_cap=512))):
        g = rc.radius_graph_batch(jax.random.PRNGKey(0), n_nodes=24,
                                  cutoff=3.0, box=6.0, **kw)
        src, dst = np.asarray(g.edge_src), np.asarray(g.edge_dst)
        ti, to, tv = rc.build_triplets(src, dst, 24)
        ev = np.asarray(g.edge_valid)
        tv = tv & ev[ti] & ev[to]
        y = np.random.default_rng(5).normal(size=g.n_graphs).astype(np.float32)
        out[name] = (g, to_port(g), (ti, to, tv), y)
    return out


def cell(arch):
    """(reference module, its Cfg, port module, its Cfg) at SMOKE widths,
    energy task, each made by its package's GNN cell code."""
    fam = ref_get_arch(arch).SMOKE.family
    dims = dict(d_feat=0, d_out=1)
    rm, rcfg = rsteps._gnn_forward_builder(fam, ref_get_arch(arch).SMOKE,
                                           dims, 512)
    pm, pcfg = psteps.gnn_forward_builder(fam, get_arch(arch).SMOKE, dims, 512)
    return fam, rm, rcfg, pm, pcfg


class Reference:
    """The reference's runs, one jitted step a model and graph: outputs,
    gradients and the AdamW update at the given parameters."""

    def __init__(self, graphs):
        self.graphs = graphs
        self.steps = {}
        self.runs = {}
        self.p0 = {}

    def params(self, arch):
        """The reference's initial tree from ``PRNGKey(1)``, as numpy."""
        if arch not in self.p0:
            _, rm, rcfg, _, _ = cell(arch)
            init = jax.jit(rm.init_params, static_argnums=1)
            self.p0[arch] = as_np(init(jax.random.PRNGKey(1), rcfg))
        return self.p0[arch]

    def step(self, arch, graph):
        if (arch, graph) not in self.steps:
            fam, rm, rcfg, _, _ = cell(arch)
            g, _, tri, y = self.graphs[graph]
            tri = tuple(jnp.asarray(t) for t in tri)
            opt = ropt.adamw(LR)

            def loss_fn(params):
                args = (tri,) if fam == "dimenet" else ()
                node, gout = rm.forward(rcfg, params, g, *args)
                return jnp.mean((gout[:, 0] - y) ** 2), (node, gout)

            @jax.jit
            def step(params, opt_state):
                (loss, out), grads = jax.value_and_grad(
                    loss_fn, has_aux=True)(params)
                new_p, new_o = opt.update(grads, opt_state, params)
                return loss, out, grads, new_p, new_o

            self.steps[arch, graph] = step, opt
        return self.steps[arch, graph]

    def run(self, arch, graph):
        """Initial parameters (PRNGKey(1)), the first step's loss, outputs
        and gradients, and the parameters after three AdamW steps."""
        if (arch, graph) not in self.runs:
            step, opt = self.step(arch, graph)
            p0 = self.params(arch)
            p = jax.tree.map(jnp.asarray, p0)
            o = opt.init(p)
            losses = []
            for i in range(3):
                loss, out, grads, p, o = step(p, o)
                losses.append(float(loss))
                if i == 0:
                    first = (as_np(out), as_np(grads))
            self.runs[arch, graph] = dict(p0=p0, losses=losses,
                                          out=first[0], grads=first[1],
                                          p3=as_np(p))
        return self.runs[arch, graph]


@pytest.fixture(scope="module")
def ref(graphs):
    return Reference(graphs)


def port_model(arch, p0):
    _, _, _, pm, pcfg = cell(arch)
    model = getattr(pm, MODULES[arch])(pcfg, device=CPU)
    model.load_state_dict(interop.gnn_params_from_jax(p0, CPU))
    return model


def port_batch(arch, graphs, graph):
    _, gp, tri, y = graphs[graph]
    batch = dict(graph=gp, labels=torch.tensor(y))
    if arch == "dimenet":
        batch.update(zip(("t_in", "t_out", "t_valid"),
                         (torch.as_tensor(t) for t in tri)))
    return batch


def port_loss(arch):
    fam, _, _, pm, pcfg = cell(arch)
    return psteps.gnn_loss(fam, pm, pcfg, "energy")


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_equal_jax_random_under_reference_names(ref, arch):
    """``init_params`` from ``threefry.prng_key(1)`` == the reference's
    from ``PRNGKey(1)`` (same tree, names, shapes, dtypes; values within
    the truncated normal's rounding); the module's state dict carries the
    reference's paths, and carrying a tree across and back is exact."""
    _, _, _, pm, pcfg = cell(arch)
    ref_tree = ref.params(arch)
    model = getattr(pm, MODULES[arch])(pcfg, key=threefry.prng_key(1),
                                       device=CPU)
    out = port_np(model)
    assert jax.tree.structure(ref_tree) == jax.tree.structure(out)
    for (path, a), b in zip(leaves_with_paths(ref_tree),
                            jax.tree.leaves(out)):
        assert a.shape == b.shape and a.dtype == b.dtype, path
        np.testing.assert_allclose(b, a, rtol=0, atol=INIT_ATOL, err_msg=path)
    flat = interop.gnn_params_from_jax(ref_tree, CPU)
    assert sorted(model.state_dict()) == sorted(flat)
    model.load_state_dict(flat)
    for a, b in zip(jax.tree.leaves(ref_tree), jax.tree.leaves(port_np(model))):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_equal_reference(ref, graphs, arch, graph):
    run = ref.run(arch, graph)
    model = port_model(arch, run["p0"])
    batch = port_batch(arch, graphs, graph)
    args = ((batch["t_in"], batch["t_out"], batch["t_valid"]),) \
        if arch == "dimenet" else ()
    with torch.no_grad():
        node, gout = model(batch["graph"], *args)
    for a, b in zip(run["out"], (node, gout)):
        assert tuple(b.shape) == a.shape
        assert bool(torch.isfinite(b).all())
        np.testing.assert_allclose(b.numpy(), a, rtol=FWD_RTOL,
                                   atol=FWD_RTOL * np.abs(a).max())


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("arch", ARCHS)
def test_parameter_gradients_equal_reference(ref, graphs, arch, graph):
    """Autograd's gradients of the energy loss == ``jax.grad``'s; finite
    in both, also on the padded graph (edges 0→0 of length 0)."""
    run = ref.run(arch, graph)
    model = port_model(arch, run["p0"])
    tree = model.tree()
    loss, _ = port_loss(arch)(tree, port_batch(arch, graphs, graph))
    np.testing.assert_allclose(loss.item(), run["losses"][0], rtol=FWD_RTOL)
    leaves = popt.tree_leaves(tree)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [np.zeros(p.shape, np.float32) if g is None else g.numpy()
             for p, g in zip(leaves, grads)]
    ref_g = leaves_with_paths(run["grads"])
    scale = max(np.abs(a).max() for _, a in ref_g)
    assert np.isfinite(scale) and scale > 0
    # both trees flatten in one order under jax.tree (sorted keys)
    for (path, a), b in zip(ref_g, jax.tree.leaves(
            popt.tree_unflatten(tree, grads))):
        assert np.isfinite(b).all(), path
        np.testing.assert_allclose(b, a, rtol=GRAD_RTOL,
                                   atol=GRAD_ATOL * scale, err_msg=path)


@pytest.mark.parametrize("graph", GRAPHS)
@pytest.mark.parametrize("arch", ARCHS)
def test_three_adamw_steps_equal_reference(ref, graphs, arch, graph):
    run = ref.run(arch, graph)
    model = port_model(arch, run["p0"])
    opt = popt.adamw(LR)
    step = ptr.make_train_step(port_loss(arch), opt)
    state = ptr.init_state(
        popt.tree_map(lambda t: t.detach().clone(), model.tree()), opt)
    batch = port_batch(arch, graphs, graph)
    losses = []
    for _ in range(3):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert all(np.isfinite(losses))
    np.testing.assert_allclose(losses, run["losses"], rtol=1e-4)
    p0 = dict(leaves_with_paths(run["p0"]))
    for (path, a), b in zip(leaves_with_paths(run["p3"]),
                            jax.tree.leaves(port_np(state.params))):
        if path.endswith("['alpha']['b']"):
            # a null direction of the softmax: rounding noise, steps of ±lr
            for x in (a, b):
                assert np.abs(x - p0[path]).max() <= 3 * LR * (1 + 1e-6), path
            continue
        np.testing.assert_allclose(b, a, rtol=0, atol=ADAM_ATOL, err_msg=path)


def test_equiformer_streaming_attention_equals_whole_edge_softmax(ref, graphs):
    """``edge_chunks`` of 2, 4 and 8 (dividing 128 and 512) against the
    whole-edge softmax, and 3 (not dividing: the whole-edge path), each
    within FWD_RTOL of the reference's outputs."""
    _, _, _, pm, pcfg = cell("equiformer-v2")
    for graph in GRAPHS:
        run = ref.run("equiformer-v2", graph)
        model = port_model("equiformer-v2", run["p0"])
        gp = graphs[graph][1]
        with torch.no_grad():
            for nb in (1, 2, 3, 4, 8):
                node, gout = pm.forward(dataclasses.replace(pcfg, edge_chunks=nb),
                                        model.tree(), gp)
                for a, b in zip(run["out"], (node, gout)):
                    np.testing.assert_allclose(
                        b.numpy(), a, rtol=FWD_RTOL,
                        atol=FWD_RTOL * np.abs(a).max(), err_msg=f"{graph} {nb}")


def test_bessel_basis_on_tensors_vs_host():
    """tests/test_models_gnn.py's check on the port (its points and its
    bound, the two-term series' error below x = 0.5) in float32 and
    float64; the host recursion equal to the reference's bit for bit; the
    float32 tensors within float32 rounding of the reference's device
    function on its points and a grid from 0 to 40."""
    xs = np.concatenate([np.linspace(0.01, 0.49, 10), np.linspace(0.5, 30, 60)])
    grid = np.concatenate([xs, np.linspace(0.0, 40.0, 801)])
    ref = rd._spherical_jn_all_jnp(6, jnp.asarray(grid, jnp.float32))
    for dtype in (torch.float32, torch.float64):
        jl = pd._spherical_jn_all(6, torch.tensor(grid, dtype=dtype))
        for l in range(7):
            host = pd._spherical_jn_np(l, xs)
            assert np.array_equal(host, rd._spherical_jn_np(l, xs))
            assert np.abs(jl[l].numpy()[:len(xs)] - host).max() < 5e-4
            if dtype == torch.float32:
                np.testing.assert_allclose(jl[l].numpy(), np.asarray(ref[l]),
                                           rtol=0, atol=BESSEL_ATOL)


def test_bessel_roots_are_the_references_and_roots():
    """The host bisection equal to the reference's at the SMOKE sizes, and
    tests/test_models_gnn.py's root check at the published (7, 6)."""
    assert pd.bessel_roots(4, 4) == rd.bessel_roots(4, 4)
    r = np.asarray(pd.bessel_roots(7, 6))
    assert r.shape == (7, 6)
    assert (np.diff(r, axis=1) > 0).all()
    for l in range(7):
        assert (np.abs(pd._spherical_jn_np(l, r[l])) < 1e-9).all()


LM_REF_ONLY = {"attn_shard", "moe_group_chunks", "scan_unroll", "attn_bias"}


def test_configs_equal_reference():
    lms = {"internlm2-1.8b", "command-r-plus-104b", "phi3-mini-3.8b",
           "llama4-maverick-400b-a17b", "kimi-k2-1t-a32b"}
    assert set(ARCHS) | {"schnet", "bst", "tripoll"} | lms == set(list_archs())
    for arch in list_archs():
        a, b = ref_get_arch(arch), get_arch(arch)
        for name in ("CONFIG", "SMOKE"):
            ra = dataclasses.asdict(getattr(a, name))
            rb = dataclasses.asdict(getattr(b, name))
            assert {k: ra[k] for k in rb} == rb
            # the LMs drop the reference's sharding and compile knobs but
            # remat, and attn_bias (tests/test_torch_lm.py holds their values)
            assert set(ra) - set(rb) == (LM_REF_ONLY if arch in lms else set())
        assert [dataclasses.asdict(c) for c in a.SHAPES] == \
            [dataclasses.asdict(c) for c in b.SHAPES]
        assert a.KIND == b.KIND
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")
    with pytest.raises(KeyError, match="unknown arch"):
        ref_get_arch("no-such-arch")


def test_gnn_cells_equal_reference():
    """Every GNN architecture × shape cell: the module's Cfg, the padded
    edge and triplet slots (the reference computes them in ``_gnn_cell``)
    and the model FLOPs."""
    assert psteps.GNN_CELL_DIMS == rsteps.GNN_CELL_DIMS
    for arch in ("schnet",) + ARCHS:
        cfg_r, cfg_p = ref_get_arch(arch).CONFIG, get_arch(arch).CONFIG
        for shape, dims in rsteps.GNN_CELL_DIMS.items():
            e_pad = rsteps._pad_up(dims["E"],
                                   32768 if dims["E"] >= 1 << 20 else 4096)
            t_cap = rsteps._pad_up(4 * dims["E"], 4096) \
                if cfg_r.family == "dimenet" else 0
            c = psteps.gnn_cell(arch, shape)
            assert (c.e_pad, c.t_cap) == (e_pad, t_cap)
            _, mc = rsteps._gnn_forward_builder(cfg_r.family, cfg_r, dims, e_pad)
            assert dataclasses.asdict(c.cfg) == dataclasses.asdict(mc)
            assert c.model_flops == 3.0 * rsteps._gnn_flops(
                cfg_r.family, cfg_r, dims, t_cap)
            assert psteps.gnn_flops(cfg_p.family, cfg_p, dims, t_cap) == \
                rsteps._gnn_flops(cfg_r.family, cfg_r, dims, t_cap)


def test_node_loss_equals_the_references_formula():
    """The node task: log-sum-exp minus the gold logit over the valid
    nodes, as ``_gnn_cell``'s loss computes it (a stand-in module returns
    fixed logits)."""
    rng = np.random.default_rng(3)
    node = rng.normal(size=(10, 5)).astype(np.float32) * 3
    labels = rng.integers(0, 5, 10).astype(np.int32)
    valid = np.arange(10) < 7
    lz = jax.nn.logsumexp(node, -1)
    gold = jnp.take_along_axis(node, labels[:, None], -1)[:, 0]
    want = float(((lz - gold) * valid).sum() / max(valid.sum(), 1))
    stub = types.SimpleNamespace(forward=lambda mc, p, g: (torch.tensor(node),
                                                           None))
    g = types.SimpleNamespace(node_valid=torch.tensor(valid))
    loss, aux = psteps.gnn_loss("nequip", stub, None, "node")(
        None, dict(graph=g, labels=torch.tensor(labels)))
    np.testing.assert_allclose(float(loss), want, rtol=1e-6)
    assert aux["nll"] is loss
