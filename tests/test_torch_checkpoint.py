"""The port's checkpoints (``repro_torch.checkpoint``) and elastic restore
(``repro_torch.launch.elastic``) vs the JAX package's.

The same trees, made from a seeded numpy draw (a parameter tree, and
``TrainState``s of AdamW and Adafactor over it, in float32 and in
bfloat16), saved by both packages: the files are equal byte for byte,
manifest included. The port restores the reference's checkpoints bit for
bit, bfloat16 leaves included, into real or ``meta`` trees; the
reference restores the port's float32 checkpoint, and raises on a
bfloat16 leaf, its own or the port's (ROADMAP Queue 3 (w)): numpy cannot
cast its ``'<V2'`` bytes to bfloat16. ``CheckpointManager``'s async
saves, rolling ``keep`` and ``restore_latest`` behave as
``tests/test_train.py`` holds the reference's; ``reshard_restore`` and
``replan_batch`` as ``tests/test_launch.py`` holds the reference's. No
jit: every reference array is made eagerly.
"""
import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from repro.checkpoint import manager as rm
from repro.launch import elastic as relastic
from repro.train import adafactor as r_adafactor
from repro.train import adamw as r_adamw
from repro.train.trainer import init_state as r_init_state
from repro_torch.checkpoint import (CheckpointManager, load_manifest,
                                    restore_pytree, save_pytree)
from repro_torch.checkpoint.manager import path_leaves
from repro_torch.launch import elastic as pelastic
from repro_torch.train import adafactor as p_adafactor
from repro_torch.train import adamw as p_adamw
from repro_torch.train.optimizer import tree_map
from repro_torch.train.trainer import init_state as p_init_state

torch.set_num_threads(1)

DTYPES = ("float32", "bfloat16")
TREES = ("params", "adamw", "adafactor")


def numpy_tree():
    rng = np.random.default_rng(0)
    draw = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return dict(blocks=dict(wq=draw(2, 4, 6), attn_norm=np.ones((2, 4), np.float32),
                            moe=dict(router=draw(2, 4, 3))),
                embed=draw(5, 4), final_norm=draw(4))


def trees(kind: str, dtype: str):
    """The reference's tree and the port's, of ``kind``, holding the same
    values (a ``TrainState`` one step on: its step counters are 1)."""
    np_tree = numpy_tree()
    ref = jax.tree.map(lambda a: jnp.asarray(a).astype(dtype), np_tree)
    port = tree_map(lambda a: torch.from_numpy(a).to(getattr(torch, dtype)),
                    np_tree)
    if kind == "params":
        return ref, port
    r_opt, p_opt = dict(adamw=(r_adamw(1e-3), p_adamw(1e-3)),
                        adafactor=(r_adafactor(1e-2), p_adafactor(1e-2)))[kind]
    rs, ps = r_init_state(ref, r_opt), p_init_state(port, p_opt)
    rs = rs.__class__(params=rs.params, opt_state=rs.opt_state,
                      step=rs.step + 1, ef=None)
    ps = ps.__class__(params=ps.params, opt_state=ps.opt_state,
                      step=ps.step + 1, ef=None)
    return rs, ps


def port_map(fn, tree):
    """``fn`` on each tensor of a port tree (a ``TrainState`` field by
    field)."""
    if dataclasses.is_dataclass(tree):
        return dataclasses.replace(tree, **{
            f.name: port_map(fn, getattr(tree, f.name))
            for f in dataclasses.fields(tree)})
    return tree_map(fn, tree)


def files(path) -> dict:
    return {f: open(os.path.join(path, f), "rb").read()
            for f in sorted(os.listdir(path))}


def port_leaves_numpy(tree) -> dict:
    """Each leaf's bits as numpy (bfloat16 as uint16)."""
    out = {}
    for k, t in path_leaves(tree):
        t = t.detach().cpu()
        out[k] = (t.view(torch.int16).numpy().view(np.uint16)
                  if t.dtype == torch.bfloat16 else t.numpy())
    return out


def ref_leaves_numpy(tree) -> dict:
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        a = np.asarray(leaf)
        out[rm.SEP.join(rm._path_part(p) for p in path)] = (
            a.view(np.uint16) if a.dtype.name == "bfloat16" else a)
    return out


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", TREES)
def test_files_equal_reference_byte_for_byte(tmp_path, kind, dtype):
    ref, port = trees(kind, dtype)
    rm.save_pytree(str(tmp_path / "ref"), ref, extra=dict(step=3, seed=1))
    save_pytree(str(tmp_path / "port"), port, extra=dict(step=3, seed=1))
    want, got = files(tmp_path / "ref"), files(tmp_path / "port")
    assert list(got) == list(want)
    assert [f for f in got if got[f] != want[f]] == []
    if kind != "params":
        keys = load_manifest(str(tmp_path / "port"))["leaves"]
        assert {".params/blocks/wq", ".opt_state/step", ".step"} <= set(keys)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", TREES)
def test_port_restores_reference_bit_for_bit(tmp_path, kind, dtype):
    """Into zeros of the port's tree and into a tree of ``meta`` tensors."""
    ref, port = trees(kind, dtype)
    path = str(tmp_path / "ck")
    rm.save_pytree(path, ref, extra=dict(step=3))
    want = ref_leaves_numpy(ref)
    zeros = port_map(torch.zeros_like, port)
    meta = port_map(lambda t: t.to("meta"), port)
    for like, device in ((zeros, None), (meta, "cpu")):
        back = restore_pytree(path, like, device)
        assert type(back) is type(port)
        got = port_leaves_numpy(back)
        assert list(got) == list(want)
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("kind", TREES)
def test_reference_restores_port_float32(tmp_path, kind):
    ref, port = trees(kind, "float32")
    path = str(tmp_path / "ck")
    save_pytree(path, port, extra=dict(step=3))
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), ref)
    back = rm.restore_pytree(path, like)
    got, want = ref_leaves_numpy(back), ref_leaves_numpy(ref)
    assert list(got) == list(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert rm.load_manifest(path)["extra"] == dict(step=3)


def test_reference_restore_raises_on_bfloat16(tmp_path):
    """ROADMAP Queue 3 (w): the reference's ``restore_pytree`` cannot read
    a bfloat16 leaf, its own or the port's (``astype`` from ``'<V2'``);
    the port's reads both, bit for bit."""
    ref, port = trees("adamw", "bfloat16")
    like = jax.tree.map(lambda x: jax.ShapeDtypeStruct(x.shape, x.dtype), ref)
    for name, save in (("ref", rm.save_pytree), ("port", save_pytree)):
        path = str(tmp_path / name)
        save(path, ref if name == "ref" else port)
        with pytest.raises(ValueError):
            rm.restore_pytree(path, like)
        back = restore_pytree(path, port_map(torch.zeros_like, port))
        got, want = port_leaves_numpy(back), port_leaves_numpy(port)
        assert all(np.array_equal(got[k], want[k]) for k in want)


def test_restore_checks_shapes_and_casts(tmp_path):
    _, port = trees("params", "float32")
    path = str(tmp_path / "ck")
    save_pytree(path, port)
    wrong = dict(port, embed=torch.zeros(4, 5))
    with pytest.raises(ValueError, match="shape mismatch for embed"):
        restore_pytree(path, wrong)
    as_bf16 = tree_map(lambda t: t.to(torch.bfloat16), port)
    back = restore_pytree(path, as_bf16)
    for (_, a), (_, b) in zip(path_leaves(back), path_leaves(as_bf16)):
        assert a.dtype == torch.bfloat16 and torch.equal(a, b)


def test_save_is_atomic_and_replaces(tmp_path):
    """A stale ``.tmp`` directory is cleared; a second save replaces the
    first wholesale."""
    path = str(tmp_path / "ck")
    os.makedirs(path + ".tmp")
    open(os.path.join(path + ".tmp", "junk"), "w").close()
    save_pytree(path, dict(a=torch.ones(3)))
    save_pytree(path, dict(b=torch.zeros(2, dtype=torch.int32)), extra=dict(x=1))
    assert sorted(os.listdir(tmp_path)) == ["ck"]
    assert sorted(os.listdir(path)) == ["b.npy", "manifest.json"]
    assert load_manifest(path) == dict(extra=dict(x=1), leaves=dict(
        b=dict(file="b.npy", shape=[2], dtype="int32")))


def test_checkpoint_manager_async_and_gc(tmp_path):
    """As tests/test_train.py holds the reference's: four async saves,
    ``keep=2`` leaves the last two, ``restore_latest`` gives step 4; the
    files equal the reference manager's."""
    trees_by = {}
    for name, mgr_cls, tree in (("port", CheckpointManager,
                                 dict(w=torch.ones((4, 4)))),
                                ("ref", rm.CheckpointManager,
                                 dict(w=jnp.ones((4, 4))))):
        mgr = mgr_cls(str(tmp_path / name), keep=2)
        for s in (1, 2, 3, 4):
            mgr.save(s, jax.tree.map(lambda x: x * s, tree))
        mgr.wait()
        assert mgr.latest_step() == 4
        assert sorted(os.listdir(str(tmp_path / name))) == [
            "step_0000000003", "step_0000000004"]
        trees_by[name] = mgr
    mgr = trees_by["port"]
    back, extra = mgr.restore_latest(dict(w=torch.zeros(4, 4)))
    assert extra == dict(step=4)
    assert torch.equal(back["w"], torch.full((4, 4), 4.0))
    for s in (3, 4):
        assert files(mgr.step_path(s)) == files(trees_by["ref"].step_path(s))
    empty = CheckpointManager(str(tmp_path / "empty"))
    assert empty.latest_step() is None
    assert empty.restore_latest(dict(w=torch.zeros(1))) == (None, None)
    for m in (mgr, trees_by["ref"], empty):
        m.close()


def test_checkpoint_manager_blocking_save_and_errors(tmp_path):
    """``block=True`` returns with the checkpoint on disk; the writer's
    error surfaces at ``wait``."""
    mgr = CheckpointManager(str(tmp_path / "run"))
    mgr.save(7, dict(w=torch.arange(3)), extra=dict(seed=2), block=True)
    assert load_manifest(mgr.step_path(7))["extra"] == dict(seed=2, step=7)
    shutil.rmtree(mgr.dir)
    open(mgr.dir, "w").close()         # the directory is gone: writes fail
    mgr.save(8, dict(w=torch.ones(1)))
    with pytest.raises(OSError):
        mgr.wait()


def test_reshard_restore_and_replan_batch_equal_reference(tmp_path):
    tree = np.arange(64, dtype=np.float32).reshape(8, 8)
    path = str(tmp_path / "ck")
    rm.save_pytree(path, dict(w=jnp.asarray(tree)), extra=dict(step=5))
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    ref, ref_extra = relastic.reshard_restore(
        path, dict(w=jax.ShapeDtypeStruct((8, 8), jnp.float32)), mesh,
        dict(w=P("data", "model")))
    got, extra = pelastic.reshard_restore(
        path, dict(w=torch.empty((8, 8), device="meta")), "cpu")
    assert extra == ref_extra == dict(step=5)
    assert got["w"].device.type == "cpu"
    np.testing.assert_array_equal(got["w"].numpy(), np.asarray(ref["w"]))
    for args in [(256, 256, 128), (256, 256, 512), (100, 16, 32), (7, 1, 3),
                 (3, 1, 8), (96, 8, 8)]:
        assert pelastic.replan_batch(*args) == relastic.replan_batch(*args)
