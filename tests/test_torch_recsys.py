"""The port's recsys family (BST) vs the JAX package's.

At ``configs/bst.py``'s ``SMOKE`` widths (float32), the reference's
weights carried across (``interop.recsys_params_from_jax``), one jitted
reference run shared by a module fixture:

- the configs, ``SHAPES`` and ``KIND`` field for field;
- ``threefry.bernoulli`` / ``torch_bernoulli`` / ``torch_randint`` and
  ``recsys_batch`` bit for bit, dtypes included;
- ``embedding_lookup`` and ``embedding_bag`` (mean and sum, with and
  without a mask, an all-masked bag, ids n, -1 and -n-1) against
  ``jnp.take`` / ``segment_sum`` within ``FWD_RTOL``, NaN where the
  reference's is NaN, and their table gradients;
- ``init_params`` within the truncated normal's ``INIT_ATOL``;
- ``forward``, ``loss_fn``, its gradients (the dense table gradients
  included) and ``retrieval_scores`` within ``FWD_RTOL`` / ``GRAD_RTOL``;
  a bfloat16 forward within ``BF16_RTOL``;
- three AdamW(1e-3) steps, as ``tests/test_configs_smoke.py::
  test_recsys_smoke_train_and_serve`` takes them, the parameters within
  :func:`_adamw_bound`. The key projection's bias (``NULL_LEAF``) shifts
  every score of a query alike, so the softmax is invariant to it and its
  gradient is 0 in exact arithmetic: both packages give rounding noise
  there, held below ``GRAD_RTOL`` of the largest gradient, and AdamW
  turns that noise into steps, held to at most lr a step in both;
- ``launch.steps.recsys_cell``'s FLOPs and batch shapes and dtypes equal
  to the reference's ``build_cell("bst", shape, mesh)`` on a (1, 1) mesh.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.data import recsys_batch as ref_recsys_batch
from repro.launch.steps import build_cell
from repro.models.recsys import bst as rb
from repro.models.recsys import embedding as re
from repro.train import make_train_step as r_make_train_step
from repro.train.optimizer import adamw as r_adamw
from repro.train.trainer import init_state as r_init_state
from repro_torch import interop
from repro_torch.configs import get_arch, list_archs
from repro_torch.data import recsys_batch
from repro_torch.launch import steps as psteps
from repro_torch.models import threefry
from repro_torch.models.recsys import bst as pb
from repro_torch.models.recsys import embedding as pe
from repro_torch.train import adamw, make_train_step
from repro_torch.train.optimizer import tree_leaves, tree_unflatten
from repro_torch.train.trainer import init_state, value_and_grad

torch.set_num_threads(1)

CPU = torch.device("cpu")
INIT_ATOL = 7.2e-7        # truncated normals (threefry.py)
FWD_RTOL = 1e-5           # logits, losses, scores, bags: of the largest
GRAD_RTOL = 1e-5          # gradients: of each leaf's largest
PARAM_RTOL = 1e-5         # parameters after three steps: of each leaf's largest
BF16_RTOL = 2e-2          # a bfloat16 forward against the reference's
NULL_LEAF = "blocks.0.wk.b"   # a null direction of the attention softmax
B = 32                    # the reference smoke test's train batch
LR = 1e-3


def _rel(ref, out) -> float:
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out.detach().float().numpy() if isinstance(out, torch.Tensor)
                     else out, np.float64)
    return float(np.abs(ref - out).max() / max(np.abs(ref).max(), 1e-30))


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _reference_run(cfg, params, batches, query):
    """On the first batch: the logits (also of the weights rounded to
    bfloat16, in bfloat16), ``loss_fn``'s value and its gradients; three
    AdamW(1e-3) steps from ``params`` over ``batches`` (a scan); retrieval
    scores of ``query``."""
    first = jax.tree.map(lambda a: a[0], batches)
    logits = rb.forward(cfg, params, first)
    logits16 = rb.forward(dataclasses.replace(cfg, dtype="bfloat16"),
                          jax.tree.map(lambda a: a.astype(jnp.bfloat16), params),
                          first)
    loss = lambda p, b: rb.loss_fn(cfg, p, b)
    (value, aux), grads = jax.value_and_grad(loss, has_aux=True)(params, first)
    opt = r_adamw(LR)
    step = r_make_train_step(loss, opt)
    state, metrics = jax.lax.scan(step, r_init_state(params, opt), batches)
    scores = rb.retrieval_scores(cfg, params, query)
    return (logits, value, aux["nll"], grads, state, metrics["loss"], scores,
            logits16.astype(jnp.float32))


_ref_batch_jit = jax.jit(ref_recsys_batch, static_argnums=(0, 1, 3, 4))


def _ref_batch(cfg, seed, step, batch, bag):
    """``repro.data.recsys_batch`` (jitted: one compile a seed and shape;
    a seed of 2³¹ or more is no int32 argument) as numpy."""
    return jax.tree.map(np.asarray, _ref_batch_jit(cfg, seed, step, batch, bag))


@pytest.fixture(scope="module")
def ref():
    """The reference's SMOKE weights (``PRNGKey(0)``) as numpy, three
    batches of ``B`` and a retrieval query over every item, and its run
    on them (one jit)."""
    cfg = ref_get_arch("bst").SMOKE
    params = jax.tree.map(np.asarray, jax.jit(
        lambda k: rb.init_params(cfg, k))(jax.random.PRNGKey(0)))
    batches = [_ref_batch(cfg, 0, i, B, 4) for i in range(3)]
    stacked = jax.tree.map(lambda *xs: np.stack(xs), *batches)
    query = dict(hist=batches[0]["hist"][:1],
                 cand_ids=np.arange(cfg.n_items, dtype=np.int32))
    out = jax.jit(_reference_run, static_argnums=0)(cfg, params, stacked, query)
    return params, batches, query, jax.tree.map(np.asarray, out)


def _names(tree) -> list:
    """Each leaf's path (``blocks.0.wk.b``), in ``jax.tree.leaves`` order."""
    return [jax.tree_util.keystr(p, simple=True, separator=".")
            for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0]]


def _port(ref):
    params, batches, query, out = ref
    return (interop.recsys_params_from_jax(params, CPU),
            [_t(b) for b in batches], _t(query), out)


# ---------------------------------------------------------------------------
# configs and data


def test_configs_shapes_and_kind_equal_reference():
    assert "bst" in list_archs()
    a, b = ref_get_arch("bst"), get_arch("bst")
    for name in ("CONFIG", "SMOKE"):
        assert dataclasses.asdict(getattr(a, name)) == \
            dataclasses.asdict(getattr(b, name))
    assert [dataclasses.asdict(c) for c in a.SHAPES] == \
        [dataclasses.asdict(c) for c in b.SHAPES]
    assert a.KIND == b.KIND == "recsys"


def test_bernoulli_and_randint_bit_for_bit():
    """numpy's and the torch twin's draws equal ``jax.random``'s, over
    seeds, shapes, probabilities and spans (one whose multiplier wraps in
    uint32: 2¹⁶ mod span = 2¹⁶)."""
    assert threefry.bernoulli(threefry.prng_key(0), 0.8, (4,)).tolist() == \
        [False, False, True, True]
    shape = (6, 5, 3)
    for seed in (0, 5, 2**31 + 3):
        key, jkey = threefry.prng_key(seed), jax.random.PRNGKey(seed)
        for p in (0.8, 0.1, 0.5, 1e-3):
            want = np.asarray(jax.random.bernoulli(jkey, p, shape))
            assert np.array_equal(threefry.bernoulli(key, p, shape), want)
            got = threefry.torch_bernoulli(key, p, shape, CPU)
            assert got.dtype == torch.bool
            assert np.array_equal(got.numpy(), want)
        for lo, hi in ((0, 20_000_000), (0, 97), (-5, 2**31 - 1), (3, 3)):
            want = np.asarray(jax.random.randint(jkey, shape, lo, hi))
            got = threefry.torch_randint(key, shape, lo, hi, CPU)
            assert got.dtype == torch.int32
            assert np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,step,batch,bag", [
    (0, 0, 32, 4), (7, 3, 5, 1), (2**31 + 1, 11, 64, 6)])
def test_recsys_batch_bit_for_bit(seed, step, batch, bag):
    cfg = get_arch("bst").SMOKE
    want = _ref_batch(ref_get_arch("bst").SMOKE, seed, step, batch, bag)
    got = recsys_batch(cfg, seed, step, batch, bag, device=CPU)
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k].numpy()
        assert g.dtype == w.dtype and np.array_equal(g, w), k


# ---------------------------------------------------------------------------
# embeddings

N_ROWS, DIM = 11, 8


def _table(seed=0):
    return np.random.default_rng(seed).normal(size=(N_ROWS, DIM)).astype(np.float32)


def _same_nan(want, got):
    """NaN exactly where the reference has NaN; the rest within FWD_RTOL."""
    want, got = np.asarray(want), got.detach().numpy()
    nan = np.isnan(want)
    assert np.array_equal(np.isnan(got), nan)
    assert _rel(np.where(nan, 0, want), np.where(nan, 0, got)) <= FWD_RTOL


def test_embedding_lookup_out_of_range_ids_equal_jnp_take():
    """Ids n and -n-1 give NaN rows, -1 the last row, -n the first, as
    ``jnp.take`` (fill mode) gives them; their gradients are dropped."""
    table = _table()
    ids = np.array([[0, N_ROWS, -1], [-N_ROWS, -N_ROWS - 1, 5]], np.int32)
    _same_nan(re.embedding_lookup(table, ids),
              pe.embedding_lookup(torch.from_numpy(table), torch.from_numpy(ids)))
    w = np.random.default_rng(1).normal(size=(2, 3, DIM)).astype(np.float32)
    inside = np.array([[1, 0, 1], [1, 0, 1]], bool)[..., None]
    want = jax.grad(lambda t: jnp.sum(jnp.where(
        inside, re.embedding_lookup(t, ids), 0.0) * w))(table)
    t = torch.from_numpy(table).requires_grad_(True)
    torch.sum(torch.where(torch.from_numpy(inside),
                          pe.embedding_lookup(t, torch.from_numpy(ids)), 0.0)
              * torch.from_numpy(w)).backward()
    assert _rel(want, t.grad) <= GRAD_RTOL


@pytest.mark.parametrize("mode,masked", [("mean", True), ("mean", False),
                                         ("sum", True), ("sum", False)])
def test_embedding_bag_equals_take_and_segment_sum(mode, masked):
    """Bags of K = 4 (the second wholly masked, the third holding id n,
    the fourth -1 and -n-1): values, NaN rows and the table's gradient
    (over the finite rows) against the reference's."""
    table = _table(2)
    rng = np.random.default_rng(3)
    ids = rng.integers(0, N_ROWS, (6, 4)).astype(np.int32)
    ids[2, 1], ids[3, 0], ids[3, 2] = N_ROWS, -1, -N_ROWS - 1
    valid = rng.random((6, 4)) < 0.7
    valid[:, 0], valid[1] = True, False
    v = valid if masked else None
    want = re.embedding_bag(table, ids, v, mode=mode)
    tt = torch.from_numpy(table).requires_grad_(True)
    vt = None if v is None else torch.from_numpy(v)
    got = pe.embedding_bag(tt, torch.from_numpy(ids), vt, mode=mode)
    _same_nan(want, got)
    finite = np.isfinite(np.asarray(want)).all(-1, keepdims=True)
    w = rng.normal(size=(6, DIM)).astype(np.float32) * finite
    g_want = jax.grad(lambda t: jnp.sum(jnp.where(
        finite, re.embedding_bag(t, ids, v, mode=mode), 0.0) * w))(table)
    torch.sum(torch.where(torch.from_numpy(finite), got, 0.0)
              * torch.from_numpy(w)).backward()
    assert _rel(g_want, tt.grad) <= GRAD_RTOL


# ---------------------------------------------------------------------------
# the model


def test_init_params_equal_reference_within_truncated_normal(ref):
    """The port's threefry draw of the SMOKE weights (16 + 4·n_blocks +
    len(mlp_dims) keys, consumed in the reference's order) against
    ``init_params(cfg, PRNGKey(0))``; :class:`BST` holds them under the
    reference's names."""
    params = ref[0]
    got = pb.init_params(get_arch("bst").SMOKE, threefry.prng_key(0), CPU)
    want_l, got_l = jax.tree.leaves(params), tree_leaves(got)
    assert len(want_l) == len(got_l)
    for a, b in zip(want_l, got_l):
        assert a.shape == tuple(b.shape) and b.dtype == torch.float32
        assert np.abs(a - b.numpy()).max() <= INIT_ATOL
    model = pb.BST(get_arch("bst").SMOKE, got)
    assert sorted(_names(params)) == sorted(model.state_dict())


def test_forward_and_retrieval_scores_equal_reference(ref):
    params, batches, query, out = _port(ref)
    cfg = get_arch("bst").SMOKE
    logits = pb.BST(cfg, params)(batches[0])
    assert logits.shape == (B,) and _rel(out[0], logits) <= FWD_RTOL
    scores = pb.retrieval_scores(cfg, params, query)
    assert scores.dtype == torch.float32 and scores.shape == (cfg.n_items,)
    assert _rel(out[6], scores) <= FWD_RTOL


def test_loss_fn_and_gradients_equal_reference(ref):
    """The loss and every leaf's gradient, the item and field tables'
    dense gradients among them."""
    params, batches, _, out = _port(ref)
    cfg = get_arch("bst").SMOKE
    loss, aux, grads = value_and_grad(lambda p, b: pb.loss_fn(cfg, p, b),
                                      params, batches[0])
    assert _rel(out[1], loss) <= FWD_RTOL and _rel(out[2], aux["nll"]) <= FWD_RTOL
    want, got = jax.tree.leaves(out[3]), tree_leaves(grads)
    assert len(want) == len(got)
    largest = max(np.abs(a).max() for a in want)
    for name, a, b in zip(_names(out[3]), want, got):
        assert a.shape == tuple(b.shape)
        if name == NULL_LEAF:
            assert max(np.abs(a).max(), b.abs().max()) <= GRAD_RTOL * largest
        else:
            assert _rel(a, b) <= GRAD_RTOL, name
    assert np.count_nonzero(out[3]["item_table"]) > 0


def test_bfloat16_forward_equals_reference(ref):
    """The SMOKE model in bfloat16, the same weights rounded: the scores'
    float32 scaling and softmax, the layer norms in bfloat16."""
    params, batches, _, out = _port(ref)
    cfg = dataclasses.replace(get_arch("bst").SMOKE, dtype="bfloat16")
    p16 = [t.to(torch.bfloat16) for t in tree_leaves(params)]
    got = pb.forward(cfg, tree_unflatten(params, p16), batches[0])
    assert got.dtype == torch.bfloat16
    assert _rel(out[7], got) <= BF16_RTOL


def _adamw_bound(want, g1, steps, lr, eps=1e-8):
    """AdamW's parameters after ``steps`` steps, held elementwise:
    ``PARAM_RTOL`` of the leaf's largest, plus lr × steps × √steps ×
    ``GRAD_RTOL`` × G / (|g₁| + eps), G the leaf's largest first gradient
    |g₁|: AdamW divides each step by the gradient's root mean square, so
    an element whose first gradient is near zero turns a gradient's
    rounding into up to lr a step."""
    g1 = np.abs(np.asarray(g1, np.float64))
    return (PARAM_RTOL * np.abs(want).max()
            + lr * steps * np.sqrt(steps) * GRAD_RTOL * g1.max() / (g1 + eps))


def test_three_adamw_steps_equal_reference(ref):
    """``recsys_cell``'s optimizer through ``make_train_step``, three
    batches: the losses and the parameters."""
    params, batches, _, out = _port(ref)
    cfg = get_arch("bst").SMOKE
    opt = adamw(LR)
    step = make_train_step(lambda p, b: pb.loss_fn(cfg, p, b), opt)
    state = init_state(params, opt)
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    assert np.isfinite(losses).all() and _rel(out[5], losses) <= FWD_RTOL
    assert int(state.step) == int(out[4].step) == 3
    p0 = jax.tree.leaves(ref[0])
    for name, a, b, g, a0 in zip(_names(out[3]), jax.tree.leaves(out[4].params),
                                 tree_leaves(state.params),
                                 jax.tree.leaves(out[3]), p0):
        if name == NULL_LEAF:
            assert max(np.abs(a - a0).max(), np.abs(b.numpy() - a0).max()) \
                <= 3 * LR
        else:
            assert (np.abs(a - b.numpy()) <= _adamw_bound(a, g, 3, LR)).all(), name


def test_recsys_params_from_jax_bfloat16_bit_for_bit(ref):
    p16 = jax.tree.map(lambda a: np.asarray(jnp.asarray(a, jnp.bfloat16)), ref[0])
    got = interop.recsys_params_from_jax(p16, CPU)
    assert all(t.dtype == torch.bfloat16 for t in tree_leaves(got))
    back = interop.params_to_numpy(got)
    for a, b in zip(jax.tree.leaves(p16), jax.tree.leaves(back)):
        assert np.array_equal(a.view(np.uint16), b)


# ---------------------------------------------------------------------------
# cells


@pytest.mark.parametrize("shape", ["train_batch", "serve_p99", "serve_bulk",
                                   "retrieval_cand"])
def test_recsys_cell_equals_reference(shape):
    """The model FLOPs and the step's batch (names, shapes, dtypes) of
    the reference's cell at CONFIG widths; the train cell's optimizer is
    AdamW(1e-3)."""
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    plan = build_cell("bst", shape, mesh)
    cell = psteps.recsys_cell("bst", shape)
    assert cell.model_flops == plan.model_flops
    want = plan.args[1]
    assert cell.inputs.keys() == want.keys()
    for k, (shp, dt) in cell.inputs.items():
        assert shp == want[k].shape
        assert str(dt).removeprefix("torch.") == str(want[k].dtype), k
    assert (cell.opt is not None) == (cell.kind == "train")
    cfg = get_arch("bst").CONFIG
    if cell.kind != "retrieval":
        per = psteps.recsys_flops(cfg) * cell.batch
        assert cell.model_flops == (3 * per if cell.kind == "train" else per)
