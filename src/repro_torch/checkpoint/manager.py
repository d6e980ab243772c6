"""Rolling checkpoints in the reference's on-disk format.

The twin of ``repro.checkpoint.manager``. Format: one ``.npy`` per leaf
keyed by its tree path, plus a JSON manifest (``extra``: step and
data-pipeline state; ``leaves``: each leaf's file, shape and dtype). For
the same tree the files are the reference's byte for byte: a key is the
reference's tree path (dict keys sorted, list indices, a dataclass's
fields as ``.name``, so a ``TrainState`` flattens to ``.params/blocks/wq``,
``.opt_state/m/...``, ``.opt_state/step``, ``.step``), its file name the
key with ``/`` → ``__``. numpy has no bfloat16 here, so a bfloat16 leaf is
written as the reference's writer leaves it: its bits under a ``'<V2'``
header, the manifest saying ``bfloat16``. Restore reinterprets each
leaf's bytes under the manifest's dtype, so it reads the reference's
bfloat16 checkpoints, which the reference's own restore cannot (its
``astype`` from ``V2`` raises). Writes are atomic (a ``.tmp`` directory,
then ``os.replace``), so a preemption mid-write never corrupts the latest
checkpoint; an async writer thread overlaps serialisation with training.
Restore places the leaves on the device asked for: on one card the
reference's "new mesh" is a device.
"""
from __future__ import annotations

import dataclasses
import json
import os
import queue
import shutil
import threading

import numpy as np
import torch

from repro_torch.utils import resolve_device

SEP = "/"
BF16_DESCR = "<V2"   # the header the reference's bfloat16 leaves carry


def path_leaves(tree, prefix: str = ""):
    """(key, leaf) of a tree (dicts, lists, tuples, dataclasses) in the
    reference's pytree order, keyed by the reference's tree paths;
    ``None`` holds none."""
    if tree is None:
        return
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        fields = [(f".{f.name}", getattr(tree, f.name))
                  for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        fields = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        fields = [(str(i), v) for i, v in enumerate(tree)]
    else:
        yield prefix, tree
        return
    for part, sub in fields:
        yield from path_leaves(sub, f"{prefix}{SEP}{part}" if prefix else part)


def _rebuild(like, leaves: dict, prefix: str = ""):
    """A tree of ``like``'s structure holding ``leaves[key]`` at each key."""
    join = lambda part: f"{prefix}{SEP}{part}" if prefix else part
    if like is None:
        return None
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        return dataclasses.replace(like, **{
            f.name: _rebuild(getattr(like, f.name), leaves, join(f".{f.name}"))
            for f in dataclasses.fields(like)})
    if isinstance(like, dict):
        return {k: _rebuild(v, leaves, join(str(k))) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, leaves, join(str(i)))
                          for i, v in enumerate(like))
    return leaves[prefix]


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True).contiguous()


def _write_leaf(path: str, t: torch.Tensor) -> tuple[list, str]:
    """Write one leaf as the reference does; its shape and dtype name."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        bits = t.view(torch.int16).numpy()
        with open(path, "wb") as f:
            np.lib.format.write_array_header_1_0(f, dict(
                descr=BF16_DESCR, fortran_order=False, shape=bits.shape))
            f.write(bits.tobytes())
        return list(bits.shape), "bfloat16"
    arr = t.numpy()
    np.save(path, arr)
    return list(arr.shape), str(arr.dtype)


def _read_leaf(path: str, dtype: str) -> torch.Tensor:
    """One leaf's bytes under the manifest's dtype."""
    arr = np.load(path)
    if dtype == "bfloat16":
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(arr.view(np.dtype(dtype)))


def save_pytree(path: str, tree, extra: dict | None = None):
    """Atomic synchronous save."""
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    manifest = dict(extra=extra or {}, leaves={})
    for key, leaf in path_leaves(tree):
        fname = key.replace(SEP, "__") + ".npy"
        shape, dtype = _write_leaf(os.path.join(tmp, fname), leaf)
        manifest["leaves"][key] = dict(file=fname, shape=shape, dtype=dtype)
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.replace(tmp, path)


def restore_pytree(path: str, like, device=None):
    """Restore into the structure of ``like`` (a tree of tensors, ``meta``
    ones allowed), each leaf cast to its ``like``'s dtype, on ``device``
    (``None``: each ``like``'s own device; the card for a ``meta`` one)."""
    leaves = load_manifest(path)["leaves"]
    out = {}
    for key, ref in path_leaves(like):
        info = leaves[key]
        t = _read_leaf(os.path.join(path, info["file"]), info["dtype"])
        if tuple(t.shape) != tuple(ref.shape):
            raise ValueError(f"shape mismatch for {key}: {tuple(t.shape)} vs "
                             f"{tuple(ref.shape)}")
        dev = device if device is not None else (
            None if ref.device.type == "meta" else ref.device)
        out[key] = t.to(device=resolve_device(dev), dtype=ref.dtype)
    return _rebuild(like, out)


def load_manifest(path: str) -> dict:
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


class CheckpointManager:
    """Rolling checkpoints with an async writer thread.

    ``save`` enqueues a host copy and returns immediately; ``wait`` joins
    outstanding writes (called before exit / preemption handoff).
    """

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._q: queue.Queue = queue.Queue()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self._errors: list = []

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                return
            step, host_tree, extra = item
            try:
                save_pytree(self.step_path(step), host_tree, extra)
                self._gc()
            except Exception as e:  # raised to the caller by wait()
                self._errors.append(e)
            finally:
                self._q.task_done()

    def step_path(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:010d}")

    def save(self, step: int, tree, extra: dict | None = None, block=False):
        host = _rebuild(tree, {k: _host(t) for k, t in path_leaves(tree)})
        self._q.put((int(step), host, dict(extra or {}, step=int(step))))
        if block:
            self.wait()

    def wait(self):
        self._q.join()
        if self._errors:
            raise self._errors[0]

    def _steps(self) -> list:
        return sorted(int(d.split("_")[1]) for d in os.listdir(self.dir)
                      if d.startswith("step_") and not d.endswith(".tmp"))

    def latest_step(self) -> int | None:
        steps = self._steps()
        return steps[-1] if steps else None

    def restore_latest(self, like, device=None):
        step = self.latest_step()
        if step is None:
            return None, None
        tree = restore_pytree(self.step_path(step), like, device)
        extra = load_manifest(self.step_path(step))["extra"]
        return tree, extra

    def _gc(self):
        for s in self._steps()[: -self.keep]:
            shutil.rmtree(self.step_path(s), ignore_errors=True)

    def close(self):
        self.wait()
        self._q.put(None)
        self._worker.join(timeout=10)
