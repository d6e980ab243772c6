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

The rank entry runs jobs (surveys, delta streams, exchanges, resident
graphs) in S long-lived processes, a :class:`RankPool`, that the parent
starts and stops::

    python -m repro_torch.launch.mesh --rank R --world S \\
        --init tcp://127.0.0.1:PORT --backend gloo [--device cpu]

Each rank reads one job at a time from its standard input and writes its
record back (per job its outputs, wall, kernel launches, collective bytes
per lane, collective and staging seconds and peak device memory), and
keeps graphs resident under keys between jobs::

    with RankPool(4, device="cpu") as pool:
        pool.submit(dict(kind="load", key="g", gr=stacked_graph))
        recs = pool.submit(dict(kind="run", key="g", survey=s, cfg=cfg))

:class:`RankRun` runs a list of jobs on a pool while the caller works.
"""
from __future__ import annotations

import argparse
import importlib
import io
import os
import select
import socket
import struct
import subprocess
import sys
import tempfile
import threading
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
    host staging copies (``stage_s``); ``graphs`` the graphs resident on
    this rank between a :class:`RankPool`'s jobs, by key."""

    rank: int
    size: int
    backend: str
    device: torch.device
    group: object = None
    counters: dict = field(default_factory=_new_counters)
    graphs: dict = field(default_factory=dict)

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


def _rank_slice(gr: ShardedDODGr, mesh: ShardMesh) -> ShardedDODGr:
    """This rank's slice of ``gr`` (the whole stack or the slice itself)
    on the rank's device."""
    if gr.row_ptr.shape[0] == gr.S:
        return shard_slice(gr, mesh.rank, device=mesh.device)
    return ShardedDODGr(**{f: getattr(gr, f) for f in META_FIELDS},
                        **{f: getattr(gr, f).to(mesh.device)
                           for f in PER_SHARD_FIELDS + REPLICATED_FIELDS})


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


def _run_load(job: dict, mesh: ShardMesh):
    """Keep the job's graph (``gr`` as :func:`_graph` reads it) resident
    under ``key``: this rank's slice, on its device."""
    mesh.graphs[job["key"]] = _rank_slice(_graph(job["gr"], mesh), mesh)
    return {}


def _run_drop(job: dict, mesh: ShardMesh):
    """Drop the resident graphs named in ``keys``."""
    for key in job["keys"]:
        del mesh.graphs[key]
    return {}


def _run_keys(job: dict, mesh: ShardMesh):
    return dict(keys=sorted(mesh.graphs))


def _run_raw(job: dict, mesh: ShardMesh):
    """``make_survey_fn(survey, cfg)`` on the graph resident under
    ``key``: the merged state (not finalized) and the stats."""
    run = engine.make_survey_fn(job["survey"], job["cfg"], mesh=mesh)
    state, stats = run(mesh.graphs[job["key"]])
    return dict(state=state, stats=stats)


def _run_wait(job: dict, mesh: ShardMesh):
    """Hold the rank ``seconds``, then meet the others at a barrier: a
    probe of the ranks' liveness (and of a rank lost mid-job)."""
    time.sleep(job["seconds"])
    dist.barrier(group=mesh.group)
    return {}


JOB_KINDS = {"survey": _run_survey, "delta": _run_delta,
             "exchange": _run_exchange, "error": _run_error,
             "load": _run_load, "drop": _run_drop, "keys": _run_keys,
             "run": _run_raw, "wait": _run_wait}


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


# the pool's pipes: each message one torch.save blob after its length


def _encode(obj) -> bytes:
    buf = io.BytesIO()
    torch.save(obj, buf)
    return struct.pack("<Q", buf.tell()) + buf.getvalue()


def _decode(blob) -> object:
    return torch.load(io.BytesIO(blob), map_location="cpu",
                      weights_only=False)


def _send(proc, data: bytes) -> None:
    """All of ``data`` to the standard input of ``proc``."""
    view, fd = memoryview(data), proc.stdin.fileno()
    while view:
        view = view[os.write(fd, view):]


def _read_message(f):
    """The next message on the binary stream ``f``; None at its end."""
    head = f.read(8)
    if len(head) < 8:
        return None
    (n,) = struct.unpack("<Q", head)
    return _decode(f.read(n))


def _serve(mesh: ShardMesh, ready: dict, out) -> None:
    """A rank's loop: its set-up record, then jobs from standard input and
    records to ``out``, until a ``stop`` job or the end of the input."""
    jobs = sys.stdin.buffer
    out.write(_encode(ready))
    out.flush()
    while True:
        job = _read_message(jobs)
        if job is None or job["kind"] == "stop":
            return
        out.write(_encode(run_job(job, mesh)))
        out.flush()


def rank_main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--init", required=True)
    ap.add_argument("--backend", default="gloo")
    ap.add_argument("--device", default=None)
    ap.add_argument("--t0", type=float, default=None,
                    help="the parent's start time (time.time())")
    ap.add_argument("--timeout", type=float, default=600.0)
    a = ap.parse_args(argv)
    from datetime import timedelta

    # records go to the standard output the rank started with; anything
    # else printed goes to the log (the standard error)
    out = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    # one intra-op thread: the ranks share the host's cores
    torch.set_num_threads(1)
    dist.init_process_group(a.backend, init_method=a.init, rank=a.rank,
                            world_size=a.world,
                            timeout=timedelta(seconds=a.timeout))
    try:
        mesh = make_shard_mesh(a.world, a.backend, a.device)
        _serve(mesh, dict(
            rank=a.rank, backend=mesh.backend, device=str(mesh.device),
            ready_s=time.time() - a.t0 if a.t0 is not None else None), out)
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
    """``jobs`` (see :data:`JOB_KINDS`) on a :class:`RankPool` of ``S``
    ranks over ``backend``, each rank's shard on ``device`` (``None``: the
    card, ``cuda:rank % cards``). :meth:`start` returns at once (a thread
    submits the jobs in turn), so the caller can work while the ranks
    run; :meth:`wait` stops the ranks and returns each rank's record, in
    rank order (``outputs``: one dict per job; ``ready_s``: seconds from
    the start to the end of the rank's set-up). A rank that fails or
    outlasts ``timeout`` seconds on a job raises with the ranks' logs
    (``workdir/rank<r>.log``); ``nccl`` with fewer cards than ranks
    raises at :meth:`start`."""

    def __init__(self, S: int, jobs: list, workdir, backend: str = "gloo",
                 device: str | None = None, timeout: float = 600.0):
        self.S, self.jobs, self.backend = S, jobs, backend
        self.device, self.timeout = device, timeout
        self.workdir = Path(workdir)

    def start(self) -> "RankRun":
        self.pool = RankPool(self.S, self.backend, self.device, self.timeout,
                             self.workdir)
        self._outputs: list = []
        self._error: BaseException | None = None

        def submit_all():
            try:
                for job in self.jobs:
                    self._outputs.append(self.pool.submit(job))
            except Exception as e:   # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=submit_all, daemon=True)
        self._thread.start()
        return self

    def wait(self) -> list[dict]:
        self._thread.join()
        ranks = self.pool.ranks
        self.pool.close()
        if self._error is not None:
            raise self._error
        return [dict(ranks[r], outputs=[out[r] for out in self._outputs])
                for r in range(self.S)]


class RankPool:
    """``S`` long-lived rank processes of this interpreter over ``backend``,
    each rank's shard on ``device`` (``None``: the card, ``cuda:rank %
    cards``), that run one job at a time (see :data:`JOB_KINDS`) and keep
    graphs resident between jobs (kinds ``load``, ``drop``, ``keys``; a
    ``run`` names a resident graph).

    The ranks start at once; :meth:`ready` waits for their set-up (the
    first :meth:`submit` waits for it too), so the caller can work
    meanwhile. :meth:`submit` sends every rank the same job (or rank r
    the r-th of a list), waits for every rank's record and returns them
    in rank order. Every rank runs the same jobs in the same order, or
    their collectives would not match: one job is in flight at a time,
    whichever thread submits it.

    A rank that exits, fails or outlasts ``timeout`` seconds on a job (or
    on its set-up) stops every rank and raises with the ranks' logs
    (``workdir/rank<r>.log``; ``None``: a new temporary directory); the
    pool stays broken, and every later call raises. :meth:`close` (or
    leaving the context) stops the ranks. ``jobs_sent`` counts the jobs
    submitted; with ``log`` set to a list, each job (rank 0's, less its
    graph) is appended to it with the ranks' records."""

    def __init__(self, S: int, backend: str = "gloo", device=None,
                 timeout: float = 600.0, workdir=None):
        if backend == "nccl":
            cards = (torch.cuda.device_count() if torch.cuda.is_available()
                     else 0)
            if cards < S:
                raise ValueError(f"nccl needs one card per rank: {S} ranks, "
                                 f"{cards} card(s); use backend='gloo'")
        self.S, self.backend, self.device = S, backend, device
        self.timeout = timeout
        self.workdir = Path(workdir if workdir is not None
                            else tempfile.mkdtemp(prefix="rankpool-"))
        self.workdir.mkdir(parents=True, exist_ok=True)
        self.jobs_sent, self.log = 0, None
        self.ranks: list[dict] | None = None   # each rank's set-up record
        self._lock = threading.Lock()
        self._broken: str | None = None
        self.procs, self._logs = [], []
        self.t0 = time.time()
        self._deadline = time.monotonic() + timeout
        env = dict(os.environ, OMP_NUM_THREADS="1")
        env["PYTHONPATH"] = os.pathsep.join(
            [str(SRC)] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                          if p])
        init = f"tcp://127.0.0.1:{free_port()}"
        try:
            for r in range(S):
                cmd = [sys.executable, "-m", "repro_torch.launch.mesh",
                       "--rank", str(r), "--world", str(S), "--init", init,
                       "--backend", backend, "--t0", repr(self.t0),
                       "--timeout", str(timeout)]
                if device is not None:
                    cmd += ["--device", str(device)]
                self._logs.append(open(self.workdir / f"rank{r}.log", "w"))
                self.procs.append(subprocess.Popen(
                    cmd, env=env, stdin=subprocess.PIPE,
                    stdout=subprocess.PIPE, stderr=self._logs[-1], bufsize=0))
        except BaseException:
            self._stop()
            raise

    def __enter__(self) -> "RankPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _stop(self) -> list:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        codes = [p.wait() for p in self.procs]
        for p in self.procs:
            for f in (p.stdin, p.stdout):
                if f is not None:
                    f.close()
        for f in self._logs:
            f.close()
        return codes

    def _fail(self, what: str):
        """Stop every rank, keep the pool broken, raise with the logs."""
        codes = self._stop()
        self._broken = (f"the rank pool failed {time.time() - self.t0:.1f} s "
                        f"after its start: {what}")
        raise RuntimeError(self._broken + "".join(
            f"\n--- rank {r} (exit {c}) ---\n"
            + (self.workdir / f"rank{r}.log").read_text()[-4000:]
            for r, c in enumerate(codes)))

    def _records(self, deadline: float, what: str) -> list:
        """One message from every rank, in rank order, by ``deadline``."""
        bufs = {r: bytearray() for r in range(self.S)}
        out: list = [None] * self.S
        fds = {p.stdout.fileno(): r for r, p in enumerate(self.procs)}
        while fds:
            left = deadline - time.monotonic()
            if left <= 0:
                self._fail(f"{what}: no record from rank(s) "
                           f"{sorted(fds.values())} within {self.timeout} s")
            readable, _, _ = select.select(list(fds), [], [], min(left, 1.0))
            for fd in readable:
                r = fds[fd]
                chunk = os.read(fd, 1 << 20)
                if not chunk:
                    self._fail(f"{what}: rank {r} exited "
                               f"(code {self.procs[r].wait()})")
                buf = bufs[r]
                buf += chunk
                if len(buf) >= 8:
                    (n,) = struct.unpack("<Q", buf[:8])
                    if len(buf) == 8 + n:
                        out[r] = _decode(bytes(buf[8:]))
                        del fds[fd]
                    elif len(buf) > 8 + n:
                        self._fail(f"{what}: rank {r} wrote past its record")
        return out

    def _check(self) -> None:
        if self._broken is not None:
            raise RuntimeError(self._broken)
        if self.ranks is None:
            self.ranks = self._records(self._deadline, "set-up")

    def ready(self) -> list[dict]:
        """Wait for the ranks' set-up: each rank's record (``rank``,
        ``backend``, ``device``, ``ready_s``: seconds from the start)."""
        with self._lock:
            self._check()
            return self.ranks

    def submit(self, job) -> list[dict]:
        """Run ``job`` (a dict for every rank, or a list of S dicts) on the
        ranks: each rank's record (:func:`run_job`), in rank order."""
        jobs = job if isinstance(job, list) else [job] * self.S
        if len(jobs) != self.S:
            raise ValueError(f"{len(jobs)} jobs for {self.S} ranks")
        kind = jobs[0]["kind"]
        with self._lock:
            self._check()
            deadline = time.monotonic() + self.timeout
            blob = _encode(job) if isinstance(job, dict) else None
            try:
                for p, j in zip(self.procs, jobs):
                    _send(p, blob if blob is not None else _encode(j))
            except OSError as e:
                self._fail(f"sending a {kind} job: {e}")
            records = self._records(deadline, f"a {kind} job")
            self.jobs_sent += 1
            if self.log is not None:
                self.log.append(({k: v for k, v in jobs[0].items()
                                  if k != "gr"}, records))
            return records

    def keys(self) -> list:
        """The keys of the graphs resident on the ranks (the same on each
        rank, or this raises)."""
        keys = [r["keys"] for r in self.submit(dict(kind="keys"))]
        if any(k != keys[0] for k in keys):
            raise RuntimeError(f"the ranks hold different graphs: {keys}")
        return keys[0]

    def close(self) -> None:
        """Stop every rank (idempotent)."""
        with self._lock:
            if self._broken is not None:
                return
            self._broken = "the rank pool is closed"
            stop = _encode(dict(kind="stop"))
            for p in self.procs:
                try:
                    _send(p, stop)
                    p.stdin.close()
                except OSError:
                    pass
            deadline = time.monotonic() + 30
            for p in self.procs:
                try:
                    p.wait(timeout=max(0.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    pass
            self._stop()


if __name__ == "__main__":
    sys.exit(rank_main())
