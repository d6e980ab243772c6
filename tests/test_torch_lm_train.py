"""The port's LM training vs the JAX package's.

At the ``SMOKE`` widths of internlm2 (dense, the train cell's AdamW) and
kimi-k2 (MoE, Adafactor), the reference's weights carried across
(``interop.lm_params_from_jax``), one jitted reference run an
architecture (a module fixture): ``loss_fn``'s value and gradients within
``GRAD_RTOL`` of each leaf's largest; three ``make_train_step`` steps of
``launch.steps.pick_opt``'s optimizer, the losses within ``GRAD_RTOL``
and the parameters within ``PARAM_RTOL`` of each leaf's largest (AdamW's
elements also within what a gradient's rounding can move them,
:func:`_adamw_bound`).
``remat`` on and off give the same gradients bit for bit, and remat
recomputes each layer. ``--accum 2`` against ``--accum 1`` as
``tests/test_train.py`` holds the reference's. ``launch.train.main`` and
``repro_torch.examples.train_lm`` at a reduced step count against the
twin example's own lines and step losses (one reference run, shared);
a preemption (SIGTERM to a ``python -m repro_torch.launch.train``
subprocess once its first checkpoint is on disk) resumed by ``--restore``
ends in the state of an uninterrupted run, bit for bit; the train
cell's FLOPs and optimizer equal the reference's.
"""
import contextlib
import dataclasses
import importlib.util
import io
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as ref_get_arch
from repro.launch import steps as rsteps
from repro.launch import train as rtrain
from repro.models import transformer as rt
from repro.train import make_train_step as r_make_train_step
from repro.train.trainer import init_state as r_init_state
from repro_torch import interop
from repro_torch.checkpoint.manager import path_leaves
from repro_torch.configs import get_arch
from repro_torch.data import lm_batch
from repro_torch.examples import expected
from repro_torch.examples import train_lm
from repro_torch.launch import steps as psteps
from repro_torch.launch import train as ptrain
from repro_torch.models import threefry
from repro_torch.models import transformer as pt
from repro_torch.train import make_train_step, sgd_momentum
from repro_torch.train.optimizer import tree_leaves
from repro_torch.train.trainer import init_state, value_and_grad

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("internlm2-1.8b", "kimi-k2-1t-a32b")
LM_ARCHS = ("internlm2-1.8b", "command-r-plus-104b", "phi3-mini-3.8b",
            "llama4-maverick-400b-a17b", "kimi-k2-1t-a32b")
GRAD_RTOL = 1e-5         # gradients, losses: of each leaf's largest
PARAM_RTOL = 1e-5        # parameters after three steps: of each leaf's largest
B, S = 2, 33             # 64 tokens a batch: two of kimi's dispatch groups
EXAMPLE_STEPS = 3        # the example's run, cut (its loss falls by step 2)
CPU = torch.device("cpu")


def _t(a):
    return torch.from_numpy(np.array(a))


def _reference_run(cfg, opt, params, batches):
    """``loss_fn``'s value and gradients at ``params`` on the first batch,
    then three ``make_train_step`` steps from ``params`` (a scan over
    ``batches``)."""
    loss = lambda p, b: rt.loss_fn(cfg, p, b)
    (value, aux), grads = jax.value_and_grad(loss, has_aux=True)(params, batches[0])
    step = r_make_train_step(loss, opt)
    state, metrics = jax.lax.scan(step, r_init_state(params, opt), batches)
    return value, aux["nll"], grads, state, metrics["loss"]


@pytest.fixture(scope="module")
def runs():
    """Each architecture's SMOKE weights (the port's threefry draw, which
    is the reference's within 1e-6) as numpy, three batches (``lm_batch``,
    the reference's bit for bit: ``tests/test_torch_lm.py``), and the
    reference's run on them (one jit)."""
    out = {}
    for arch in ARCHS:
        mod = ref_get_arch(arch)
        cfg = mod.SMOKE
        params = interop.params_to_numpy(pt.init_params(
            get_arch(arch).SMOKE, threefry.prng_key(0), CPU))
        batches = np.stack([lm_batch(0, i, B, S, cfg.vocab, CPU).numpy()
                            for i in range(3)])
        ref = jax.jit(_reference_run, static_argnums=(0, 1))(
            cfg, rsteps._pick_opt(mod), params, batches)
        out[arch] = (params, list(batches), jax.tree.map(np.asarray, ref))
    return out


def _load_twin():
    spec = importlib.util.spec_from_file_location(
        "_twin_train_lm", ROOT / "examples" / "train_lm.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def twin(tmp_path_factory):
    """The JAX package's ``examples/train_lm.py`` run for
    ``EXAMPLE_STEPS`` steps: its printed text and each step's loss (a
    ``jax.debug.callback`` on its train step, as
    ``tools/record_example_lines.py`` records it)."""
    losses, make = [], rtrain.make_train_step

    def recording(loss_fn, opt, **kw):
        step = make(loss_fn, opt, **kw)

        def wrapped(state, batch):
            state, m = step(state, batch)
            jax.debug.callback(lambda x: losses.append(float(x)), m["loss"],
                               ordered=True)
            return state, m
        return wrapped

    argv, buf = sys.argv, io.StringIO()
    sys.argv = ["train_lm.py", "--steps", str(EXAMPLE_STEPS), "--ckpt-dir",
                str(tmp_path_factory.mktemp("twin"))]
    rtrain.make_train_step = recording
    try:
        with contextlib.redirect_stdout(buf):
            _load_twin().main()
    finally:
        sys.argv, rtrain.make_train_step = argv, make
    return buf.getvalue(), losses


def _rel(ref, out) -> float:
    ref = np.asarray(ref, np.float64)
    out = np.asarray(out.detach().numpy() if isinstance(out, torch.Tensor)
                     else out, np.float64)
    return float(np.abs(ref - out).max() / max(np.abs(ref).max(), 1e-30))


def _port(runs, arch):
    params, batches, ref = runs[arch]
    return (interop.lm_params_from_jax(params, CPU), [_t(b) for b in batches],
            ref)


def _grads(cfg, params, tokens):
    loss, aux, grads = value_and_grad(lambda p, b: pt.loss_fn(cfg, p, b),
                                      params, tokens)
    return loss, aux, tree_leaves(grads)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_fn_gradients_equal_reference(runs, arch):
    params, batches, ref = _port(runs, arch)
    value, nll, grads, _, _ = ref
    loss, aux, got = _grads(get_arch(arch).SMOKE, params, batches[0])
    assert _rel(value, loss) <= GRAD_RTOL and _rel(nll, aux["nll"]) <= GRAD_RTOL
    want = jax.tree.leaves(grads)
    assert len(got) == len(want)
    for a, b in zip(want, got):
        assert a.shape == tuple(b.shape)
        assert _rel(a, b) <= GRAD_RTOL


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_equals_off_bit_for_bit(runs, arch, monkeypatch):
    """The same gradients with ``remat`` on and off; with it on, each
    layer's forward runs again in the backward."""
    params, batches, _ = _port(runs, arch)
    cfg = get_arch(arch).SMOKE
    assert cfg.remat is True        # the reference's default
    calls, block = [], pt._block

    def counted(*a, **kw):
        calls.append(1)
        return block(*a, **kw)

    monkeypatch.setattr(pt, "_block", counted)
    out = {}
    for remat in (True, False):
        calls.clear()
        out[remat] = _grads(dataclasses.replace(cfg, remat=remat), params,
                            batches[0])
        assert len(calls) == cfg.n_layers * (2 if remat else 1)
    assert torch.equal(out[True][0], out[False][0])
    assert all(torch.equal(a, b) for a, b in zip(out[True][2], out[False][2]))


def _adamw_bound(want, g1, steps, lr, eps=1e-8):
    """AdamW's parameters after ``steps`` steps, held elementwise:
    ``PARAM_RTOL`` of the leaf's largest, plus lr × steps × √steps ×
    ``GRAD_RTOL`` × G / (|g₁| + eps), G the leaf's largest first gradient
    |g₁|: AdamW divides each step by the gradient's root mean square
    (at step t at least |g₁| / √t), so an element whose first gradient is
    near zero turns a gradient's rounding into up to lr a step."""
    g1 = np.abs(np.asarray(g1, np.float64))
    return (PARAM_RTOL * np.abs(want).max()
            + lr * steps * np.sqrt(steps) * GRAD_RTOL * g1.max() / (g1 + eps))


@pytest.mark.parametrize("arch", ARCHS)
def test_three_train_steps_equal_reference(runs, arch):
    """``pick_opt``'s optimizer: AdamW(3e-4) for internlm2, Adafactor(1e-2)
    for kimi-k2."""
    params, batches, ref = _port(runs, arch)
    _, _, _, r_state, r_losses = ref
    mod = get_arch(arch)
    opt = psteps.pick_opt(mod)
    step = make_train_step(lambda p, b: pt.loss_fn(mod.SMOKE, p, b), opt)
    state = init_state(params, opt)
    losses = []
    for b in batches:
        state, m = step(state, b)
        losses.append(float(m["loss"]))
    assert _rel(r_losses, np.array(losses)) <= GRAD_RTOL
    assert int(state.step) == int(r_state.step) == 3
    want = jax.tree.leaves(r_state.params)
    got = [t.numpy() for t in tree_leaves(state.params)]
    if getattr(mod, "OPTIMIZER", "adamw") == "adamw":
        g1 = jax.tree.leaves(ref[2])
        for a, b, g in zip(want, got, g1):
            assert (np.abs(a - b) <= _adamw_bound(a, g, 3, 3e-4)).all()
    else:
        for a, b in zip(want, got):
            assert _rel(a, b) <= PARAM_RTOL


def test_accum_2_equals_accum_1(runs):
    """As tests/test_train.py holds the reference's: SGD without momentum,
    one step on a batch and on its two halves accumulated."""
    params, _, _ = _port(runs, "internlm2-1.8b")
    cfg = get_arch("internlm2-1.8b").SMOKE
    big = lm_batch(0, 0, 4, S, cfg.vocab, CPU)
    opt = sgd_momentum(1e-2, momentum=0.0)
    loss = lambda p, b: pt.loss_fn(cfg, p, b)
    s1, m1 = make_train_step(loss, opt)(init_state(params, opt), big)
    s2, m2 = make_train_step(loss, opt, accum_steps=2)(
        init_state(params, opt), big.reshape(2, 2, S))
    d = max(float((a - b).abs().max()) for a, b in
            zip(tree_leaves(s1.params), tree_leaves(s2.params)))
    assert d < 5e-6, d
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 1e-5


def test_lm_train_flops_and_pick_opt_equal_reference():
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    tree = dict(w=np.linspace(-1, 1, 12, dtype=np.float32).reshape(3, 4),
                b=np.linspace(0, 1, 4, dtype=np.float32))
    g = jax.tree.map(lambda a: (a * 0.5 + 0.1).astype(np.float32), tree)
    for arch in LM_ARCHS:
        cfg = get_arch(arch).CONFIG
        cell = next(c for c in get_arch(arch).SHAPES if c.kind == "train")
        plan = rsteps.build_cell(arch, cell.name, mesh)
        assert psteps.lm_train_flops(cfg, cell.global_batch, cell.seq_len) \
            == plan.model_flops
        r_opt = rsteps._pick_opt(ref_get_arch(arch))
        p_opt = psteps.pick_opt(get_arch(arch))
        r_new, _ = jax.jit(r_opt.update)(g, r_opt.init(tree), tree)
        p_new, _ = p_opt.update(jax.tree.map(_t, g), p_opt.init(
            jax.tree.map(_t, tree)), jax.tree.map(_t, tree))
        for k in tree:
            np.testing.assert_allclose(p_new[k].numpy(), np.asarray(r_new[k]),
                                       rtol=1e-6, atol=1e-7)
    assert psteps.lm_train_flops(get_arch("internlm2-1.8b").CONFIG, 8, 2048) \
        == 195_602_675_662_848.0


def _example_numbers(keep):
    losses = keep["losses"]
    n = max(1, len(losses) // 10)
    return dict(losses=losses, first=float(np.mean(losses[:n])),
                last=float(np.mean(losses[-n:])))


def test_train_main_equal_twin(twin, tmp_path):
    """``launch.train.main --device cpu`` with the example's flags: its
    lines and step losses against the twin example's run."""
    text, losses = twin
    keep, buf = {}, io.StringIO()
    argv = train_lm.driver_argv(EXAMPLE_STEPS, False, str(tmp_path))
    with contextlib.redirect_stdout(buf):
        ptrain.main(argv + ["--device", "cpu"], keep=keep)
    assert expected.check_train_lm(buf.getvalue(), _example_numbers(keep),
                                   text, losses) == []
    assert keep["cfg"] == get_arch("internlm2-1.8b").SMOKE
    assert int(keep["state"].step) == EXAMPLE_STEPS
    assert sorted(os.listdir(tmp_path)) == [f"step_{EXAMPLE_STEPS:010d}"]


def test_train_lm_example_equal_twin(twin):
    text, losses = twin
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        numbers = train_lm.main(["--steps", str(EXAMPLE_STEPS)], device="cpu")
    assert expected.check_train_lm(buf.getvalue(), numbers, text, losses) == []
    assert get_arch("internlm2-1.8b").SMOKE.name == "internlm2-smoke"
    assert train_lm.HUNDRED_M.n_params == 80_032_256


def test_preemption_resumes_bit_for_bit(tmp_path):
    """SIGTERM once the first checkpoint is on disk: the run checkpoints
    where it stopped and exits 0; ``--restore`` runs on from there to
    the end, in the state an uninterrupted run ends in, bit for bit."""
    ckpt = tmp_path / "run"
    flags = ["--arch", "internlm2-1.8b", "--smoke", "--batch", str(B),
             "--seq", str(S), "--ckpt-every", "2", "--log-every", "1000",
             "--device", "cpu"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    handler = signal.getsignal(signal.SIGTERM)
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.train", *flags,
         "--steps", "100000", "--ckpt-dir", str(ckpt)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        t0 = time.monotonic()
        while not (ckpt / f"step_{2:010d}").is_dir():
            assert proc.poll() is None and time.monotonic() - t0 < 60, \
                proc.stderr.read() if proc.poll() is not None else "timeout"
            time.sleep(0.01)
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=60)
    finally:
        proc.kill()
    assert proc.returncode == 0, err
    assert "preemption signal: checkpointing and exiting" in out
    stopped = max(int(d.split("_")[1]) for d in os.listdir(ckpt))
    end = stopped + 3
    resumed, straight = {}, {}
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        ptrain.main(flags + ["--steps", str(end), "--ckpt-dir", str(ckpt),
                             "--restore"], keep=resumed)
        ptrain.main(flags + ["--steps", str(end)], keep=straight)
    assert f"restored step {stopped} from {ckpt}" in buf.getvalue()
    assert resumed["losses"] == straight["losses"][stopped:]
    a, b = list(path_leaves(resumed["state"])), list(path_leaves(straight["state"]))
    assert [k for k, _ in a] == [k for k, _ in b]
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(a, b))
    assert signal.getsignal(signal.SIGTERM) is handler
