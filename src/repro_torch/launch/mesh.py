"""The mesh: one survey shard per ``torch.distributed`` rank.

Inside each of S ranks, after ``torch.distributed.init_process_group``::

    mesh = make_shard_mesh(S)              # the rank's card, cuda:rank % cards
    res, st = survey_push_pull(gr, survey, cfg, mesh=mesh)

``gr`` is the whole stacked graph or the rank's slice
(``core.dodgr.shard_slice``, or :func:`load_slice` of a file
:func:`save_slices` wrote); ``cfg`` a ``transport="mesh"`` plan, or a dense
plan relabelled ``mesh`` (uniform caps). Every rank returns the merged
result.

Backends: ``nccl`` needs one card per rank. ``gloo`` takes any number of
ranks per card (they share it) or ``device="cpu"``; with the shards on a
card, the transport copies each collective's operand to host memory and
the delivered buffer back (:meth:`ShardMesh.to_wire` /
:meth:`ShardMesh.from_wire`), timed apart from the collectives.

The rank entry runs a list of jobs (surveys, delta streams, exchanges)
saved to a file, in S processes the parent starts and stops
(:class:`RankRun`)::

    python -m repro_torch.launch.mesh --rank R --world S \\
        --init tcp://127.0.0.1:PORT --backend gloo [--device cpu] \\
        --jobs JOBS.pt --out DIR

Each rank writes ``DIR/rank<R>.pt``: per job its outputs, wall, kernel
launches, collective bytes per lane, collective and staging seconds and
peak device memory; and the seconds from the parent's start to the end of
its own set-up.
"""
from __future__ import annotations

import argparse
import importlib
import os
import socket
import subprocess
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path

import torch
import torch.distributed as dist

from repro_torch.comm.mesh_exchange import MeshExchange
from repro_torch.core import engine
from repro_torch.core.dodgr import (META_FIELDS, PER_SHARD_FIELDS,
                                    REPLICATED_FIELDS, ShardedDODGr,
                                    shard_slice)
from repro_torch.interop import state_to_numpy
from repro_torch.utils import resolve_device

SRC = Path(__file__).resolve().parents[2]
# kernel wrappers and their launch counters (ops module, counter)
KERNEL_COUNTERS = {
    "wedge_check": ("wedge_check", "launches"),
    "wedge_intersect": ("wedge_intersect", "launches"),
    "fold_count_max": ("fold_scatter", "launches"),
    "ring_set": ("fold_scatter", "ring_set_launches"),
    "intersect": ("intersect", "launches"),
    "hist_add": ("hist", "hist_add_launches"),
    "hist_max": ("hist", "hist_max_launches"),
}


def _new_counters() -> dict:
    return dict(bytes={}, calls={}, wire_s=0.0, stage_s=0.0)


@dataclass
class ShardMesh:
    """A rank's place in the mesh: its rank, the mesh size, the backend,
    the device its shard lives on and the process group; ``counters``
    gather the bytes handed to the collectives per lane (``bytes``,
    ``calls``), the seconds in the collectives (``wire_s``) and in the
    host staging copies (``stage_s``)."""

    rank: int
    size: int
    backend: str
    device: torch.device
    group: object = None
    counters: dict = field(default_factory=_new_counters)

    @property
    def staged(self) -> bool:
        """Whether collectives go through host memory (gloo, shards on a
        card)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def wire_device(self) -> torch.device:
        return torch.device("cpu") if self.backend == "gloo" else self.device

    def reset_counters(self) -> None:
        self.counters = _new_counters()

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def to_wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` where the backend takes it: a host copy under gloo with
        the shard on a card (the wait for the card's queue is not counted
        as staging), else ``t`` itself."""
        t = t.contiguous()
        if not self.staged:
            return t
        self._sync()
        t0 = time.perf_counter()
        h = t.to("cpu")
        self.counters["stage_s"] += time.perf_counter() - t0
        return h

    def from_wire(self, t: torch.Tensor) -> torch.Tensor:
        """A delivered buffer on the shard's device."""
        if not self.staged:
            return t
        t0 = time.perf_counter()
        d = t.to(self.device)
        self._sync()
        self.counters["stage_s"] += time.perf_counter() - t0
        return d

    def count(self, lane: str, t: torch.Tensor) -> None:
        """Count ``t``'s bytes as handed to a collective on ``lane``."""
        c = self.counters
        c["bytes"][lane] = c["bytes"].get(lane, 0) + t.numel() * t.element_size()
        c["calls"][lane] = c["calls"].get(lane, 0) + 1

    def waited(self, t0: float) -> None:
        """Add the seconds since ``t0`` (a collective and its wait) to
        ``wire_s``; under nccl the card is waited for first."""
        if self.backend == "nccl":
            self._sync()
        self.counters["wire_s"] += time.perf_counter() - t0

    def all_gather(self, t: torch.Tensor, lane: str = "merge") -> list:
        """Every rank's ``t`` (one shape on every rank), in rank order, on
        this rank's device."""
        w = self.to_wire(t)
        outs = [torch.empty_like(w) for _ in range(self.size)]
        self.count(lane, w)
        t0 = time.perf_counter()
        dist.all_gather(outs, w, group=self.group)
        self.waited(t0)
        return [self.from_wire(o) for o in outs]


def make_shard_mesh(S: int, backend: str | None = None,
                    device=None) -> ShardMesh:
    """This rank's :class:`ShardMesh` of an ``S``-shard mesh, called in each
    rank after ``torch.distributed.init_process_group`` (whose world is the
    mesh). ``device=None`` is the card ``cuda:rank % cards`` (and raises
    without one); pass ``device="cpu"`` for the plain path. Raises when
    the world size is not ``S``, when ``backend`` is not the group's, and
    when ``nccl`` has fewer cards than ranks."""
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError("make_shard_mesh runs in a rank: call "
                           "torch.distributed.init_process_group first")
    size, rank = dist.get_world_size(), dist.get_rank()
    if size != S:
        raise ValueError(f"need {S} ranks for a {S}-shard mesh but the "
                         f"process group has {size}")
    be = dist.get_backend()
    if backend is not None and backend != be:
        raise ValueError(f"asked for backend {backend!r}, but the process "
                         f"group runs {be!r}")
    if device is None:
        resolve_device(None)
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    else:
        dev = resolve_device(device)
    if be == "nccl":
        cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if cards < S or dev.type != "cuda":
            raise ValueError(
                f"nccl needs one card per rank: {S} ranks, {cards} card(s), "
                f"device {dev}; use backend='gloo' for ranks that share a "
                "card or run on the CPU")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    mesh = ShardMesh(rank, size, be, dev, group=dist.group.WORLD)
    # the group's first collective has every rank in it (a scheduled
    # round's partial permutation leaves some out)
    mesh.all_gather(torch.zeros(1, dtype=torch.int32, device=dev))
    mesh.reset_counters()
    return mesh


# ---------------------------------------------------------------------------
# shard files: the parent builds the shards once, each rank loads its slice


def save_slices(gr: ShardedDODGr, directory) -> None:
    """Write each rank's slice (``shard_slice``) of the stacked ``gr`` to
    ``directory/slice<r>.pt``."""
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    for r in range(gr.S):
        sl = shard_slice(gr, r, device="cpu")
        torch.save({f: getattr(sl, f) for f in
                    PER_SHARD_FIELDS + REPLICATED_FIELDS + META_FIELDS},
                   directory / f"slice{r}.pt")


def load_slice(path, device) -> ShardedDODGr:
    """A slice :func:`save_slices` wrote, on ``device``."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    dev = resolve_device(device)
    kw = {f: blob[f].to(dev) for f in PER_SHARD_FIELDS + REPLICATED_FIELDS}
    kw.update({f: blob[f] for f in META_FIELDS})
    return ShardedDODGr(**kw)


# ---------------------------------------------------------------------------
# the rank entry: jobs


def _ops(mod: str):
    return importlib.import_module(f"repro_torch.kernels.{mod}.ops")


def read_launches() -> dict:
    return {k: getattr(_ops(m), c) for k, (m, c) in KERNEL_COUNTERS.items()}


def reset_launches() -> None:
    for m, c in KERNEL_COUNTERS.values():
        setattr(_ops(m), c, 0)


def _host(x):
    """Tensors of a result tree on the host (numpy stays numpy)."""
    if isinstance(x, dict):
        return {k: _host(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(_host(v) for v in x)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return x


class _Largest:
    """Wraps a kernel wrapper to keep a host copy of the operands of its
    largest launch (by operand size; the first of equal sizes). The
    wrapped function still counts its launches."""

    def __init__(self, name: str):
        mod, counter = KERNEL_COUNTERS[name]
        self.module, self.name, self.counter = _ops(mod), name, counter
        self.fn = getattr(self.module, name)
        self.size, self.entry = -1, None
        setattr(self.module, name, self)

    def __call__(self, *args, **kw):
        before = getattr(self.module, self.counter)
        out = self.fn(*args, **kw)
        if getattr(self.module, self.counter) > before:
            size = sum(a.numel() for a in args if isinstance(a, torch.Tensor))
            if size > self.size:
                self.size, self.entry = size, (_host(args), dict(kw))
        return out

    def restore(self):
        setattr(self.module, self.name, self.fn)


def _graph(spec, mesh: ShardMesh) -> ShardedDODGr:
    """A job's graph: a stacked ``ShardedDODGr`` (the survey function
    takes the rank's slice) or a path with ``{rank}`` in it
    (:func:`save_slices`'s files)."""
    if isinstance(spec, (str, Path)):
        return load_slice(str(spec).format(rank=mesh.rank), mesh.device)
    return spec


def _run_survey(job: dict, mesh: ShardMesh):
    gr = _graph(job["gr"], mesh)
    survey, cfg, entry = job["survey"], job["cfg"], job["entry"]
    if entry == "fn":
        merged, stats = engine.make_survey_fn(survey, cfg, mesh=mesh)(gr)
        return dict(state=state_to_numpy(merged), stats=stats,
                    result=survey.finalize(merged))
    fn = {"push": engine.survey_push_only,
          "pushpull": engine.survey_push_pull}[entry]
    result, stats = fn(gr, survey, cfg, mesh=mesh)
    return dict(result=result, stats=stats)


def _run_delta(job: dict, mesh: ShardMesh):
    """Epochs of a delta stream: ``grs`` and ``cfgs`` per epoch."""
    survey, state, stats = job["survey"], None, []
    for gr, cfg in zip(job["grs"], job["cfgs"]):
        state, st = engine.survey_delta(_graph(gr, mesh), survey, cfg, state,
                                        mesh=mesh)
        stats.append(st)
    return dict(state=state_to_numpy(state), stats=stats,
                result=engine.finalize_epochs(survey, state))


def _run_exchange(job: dict, mesh: ShardMesh):
    """One scatter, then a gather of what it delivered, through a
    ``MeshExchange`` of ``caps``; ``tree`` holds [S, out_cap, ...]
    stacked send buffers, of which the rank ships its row."""
    ex = MeshExchange(job["caps"], mesh=mesh)
    view = ex.local_view(mesh.rank)
    tree = {k: v[mesh.rank:mesh.rank + 1].to(mesh.device)
            for k, v in job["tree"].items()}
    rec = view.scatter(tree)
    back = view.gather(rec)
    return dict(scatter=_host(rec), gather=_host(back),
                wire_round_slots=ex.wire_round_slots())


def _run_error(job: dict, mesh: ShardMesh):
    """A survey job that must raise ``ValueError``: its message."""
    try:
        _run_survey(job, mesh)
    except ValueError as e:
        return dict(error=str(e))
    raise AssertionError("the job ran; it should have raised ValueError")


JOB_KINDS = {"survey": _run_survey, "delta": _run_delta,
             "exchange": _run_exchange, "error": _run_error}


def run_job(job: dict, mesh: ShardMesh) -> dict:
    """Run one job on this rank: its outputs, with the wall, the kernel
    launches, the collective bytes per lane, the collective and staging
    seconds and the peak device memory of its run. ``job["capture"]``
    names kernels whose largest launch on rank 0 is kept (host copies of
    its operands)."""
    dev = mesh.device
    caps = ([_Largest(k) for k in job.get("capture", ())]
            if mesh.rank == 0 else [])
    mesh.reset_counters()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    resident = torch.cuda.memory_allocated(dev) if dev.type == "cuda" else 0
    reset_launches()
    t0 = time.perf_counter()
    try:
        out = JOB_KINDS[job["kind"]](job, mesh)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    finally:
        for c in caps:
            c.restore()
    out = _host(out)
    out.update(
        wall_s=time.perf_counter() - t0, launches=read_launches(),
        bytes=dict(mesh.counters["bytes"]), calls=dict(mesh.counters["calls"]),
        wire_s=mesh.counters["wire_s"], stage_s=mesh.counters["stage_s"],
        resident=resident,
        peak=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0,
        captured={c.name: c.entry for c in caps})
    return out


def rank_main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--device", default=None)
    ap.add_argument("--jobs", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--t0", type=float, default=None,
                    help="the parent's start time (time.time())")
    ap.add_argument("--timeout", type=float, default=600.0)
    a = ap.parse_args(argv)
    from datetime import timedelta

    # one intra-op thread: the ranks share the host's cores
    torch.set_num_threads(1)
    dist.init_process_group(a.backend, init_method=a.init, rank=a.rank,
                            world_size=a.world,
                            timeout=timedelta(seconds=a.timeout))
    try:
        mesh = make_shard_mesh(a.world, a.backend, a.device)
        ready_s = time.time() - a.t0 if a.t0 is not None else None
        jobs = torch.load(a.jobs, map_location="cpu", weights_only=False)
        outputs = [run_job(job, mesh) for job in jobs]
        torch.save(dict(rank=a.rank, ready_s=ready_s, backend=mesh.backend,
                        device=str(mesh.device), outputs=outputs),
                   Path(a.out) / f"rank{a.rank}.pt")
        dist.barrier()
    finally:
        dist.destroy_process_group()
    return 0


# ---------------------------------------------------------------------------
# the parent: start S ranks, wait for them, stop them


def free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RankRun:
    """``S`` rank processes of this interpreter running ``jobs`` (see
    :data:`JOB_KINDS`) over ``backend``, each rank's shard on ``device``
    (``None``: the card, ``cuda:rank % cards``). :meth:`start` returns at
    once, so the caller can work while the ranks run; :meth:`wait`
    returns each rank's record, in rank order (``outputs``: one dict per
    job; ``ready_s``: seconds from the start to the end of the rank's
    set-up). Every process is stopped before :meth:`wait` returns; a rank
    that fails or outlasts ``timeout`` seconds raises with the ranks'
    output."""

    def __init__(self, S: int, jobs: list, workdir, backend: str = "gloo",
                 device: str | None = None, timeout: float = 600.0):
        if backend == "nccl":
            cards = (torch.cuda.device_count() if torch.cuda.is_available()
                     else 0)
            if cards < S:
                raise ValueError(f"nccl needs one card per rank: {S} ranks, "
                                 f"{cards} card(s); use backend='gloo'")
        self.S, self.jobs, self.backend = S, jobs, backend
        self.device, self.timeout = device, timeout
        self.workdir = Path(workdir)
        self.procs, self.logs = [], []

    def start(self) -> "RankRun":
        wd = self.workdir
        wd.mkdir(parents=True, exist_ok=True)
        for old in wd.glob("rank*.pt"):
            old.unlink()
        torch.save(self.jobs, wd / "jobs.pt")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(SRC)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                          if p])
        env["OMP_NUM_THREADS"] = "1"
        self.t0 = time.time()
        self.deadline = time.monotonic() + self.timeout
        init = f"tcp://127.0.0.1:{free_port()}"
        try:
            for r in range(self.S):
                cmd = [sys.executable, "-m", "repro_torch.launch.mesh",
                       "--rank", str(r), "--world", str(self.S),
                       "--init", init, "--backend", self.backend,
                       "--jobs", str(wd / "jobs.pt"), "--out", str(wd),
                       "--t0", repr(self.t0),
                       "--timeout", str(self.timeout)]
                if self.device is not None:
                    cmd += ["--device", str(self.device)]
                self.logs.append(open(wd / f"rank{r}.log", "w"))
                self.procs.append(subprocess.Popen(
                    cmd, env=env, stdout=self.logs[-1],
                    stderr=subprocess.STDOUT))
        except BaseException:
            self._stop()
            raise
        return self

    def _stop(self) -> list:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in self.logs:
            f.close()
        return [p.returncode for p in self.procs]

    def wait(self) -> list[dict]:
        try:
            while any(p.poll() is None for p in self.procs):
                if any(p.poll() not in (None, 0) for p in self.procs):
                    break
                if time.monotonic() > self.deadline:
                    break
                time.sleep(0.05)
        finally:
            codes = self._stop()
        if any(codes):
            tails = "\n".join(
                f"--- rank {r} (exit {c}) ---\n"
                + (self.workdir / f"rank{r}.log").read_text()[-4000:]
                for r, c in enumerate(codes) if c)
            raise RuntimeError(f"mesh ranks failed or timed out after "
                               f"{time.time() - self.t0:.1f} s:\n{tails}")
        return [torch.load(self.workdir / f"rank{r}.pt", map_location="cpu",
                           weights_only=False) for r in range(self.S)]


if __name__ == "__main__":
    sys.exit(rank_main())
