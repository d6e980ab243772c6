#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

    python3 chip_smoke.py        # one GPU; takes no arguments

Phases (every failure ends the run with a non-zero exit):

1. ``build``   — print torch/CUDA versions and the card's name and power
   limit; build the three CUDA kernels from ``src/repro_torch/csrc``.
2. ``kernels`` — each kernel equals its plain PyTorch version on the card,
   on random inputs and edge cases (hashes ≥ 2³¹, empty rows, slots -1 and
   ≥ cap, batches that fill no tile, pulled rows narrower than L).
3. ``small``   — karate, clique(8) and rmat(9, 16) with S ∈ {1, 4}, push and
   push-pull, dense and ragged, TriangleCount and DegreeTriples: results
   and stats on the card equal the port on the CPU, and the triangle
   count equals the pure-Python oracle. DegreeTriples' float32 degree bins
   on the card equal the CPU's around every power of two up to 2³¹.
4. ``full``    — the deployment: Graph500 R-MAT (a=0.57, b=0.19, c=0.19),
   scale 18, edge factor 16, seed 0, with degree metadata, S=8 logical
   shards on the card, dense transport, ``plan_engine(..., push_cap=4096,
   pull_q_cap=16)``; TriangleCount and DegreeTriples(capacity=4096), push
   and push-pull, through the user entry points. Push equals push-pull,
   the DegreeTriples total equals the triangle count, every run is exact,
   every kernel launched. The peak device memory is read from that run;
   a later DegreeTriples push-pull run captures the inputs of one push and
   one pull superstep, on which each kernel equals its plain version.
5. Timing of each kernel at those captured shapes (median of CUDA-event
   times), its plain version's, its bound, and one ``kernels`` JSON line.

The last line of standard output is ``{"ok": true, "device": {...}}``.
Details go to ``build/chip_smoke.json``. The script imports nothing
of JAX; it needs ``src/repro_torch`` beside it.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FULL_SCALE = 18                # R-MAT scale of the full-size deployment
HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory rate (data sheet)
# The data sheet gives no int32 rate; its float32 rate outside the tensor
# cores (67 T/s) is at least the int32 one, so the bound stays a lower bound
PEAK_OPS_PER_S = 67e12
INT32_MIN = -(2**31)

# Zachary's karate club (the 78 edges networkx ships); the card's machine
# has no networkx, and from_edges canonicalises the order anyway
KARATE_EDGES = (
    (0, 1), (0, 2), (0, 3), (0, 4), (0, 5), (0, 6), (0, 7), (0, 8), (0, 10),
    (0, 11), (0, 12), (0, 13), (0, 17), (0, 19), (0, 21), (0, 31), (1, 2),
    (1, 3), (1, 7), (1, 13), (1, 17), (1, 19), (1, 21), (1, 30), (2, 3),
    (2, 7), (2, 8), (2, 9), (2, 13), (2, 27), (2, 28), (2, 32), (3, 7),
    (3, 12), (3, 13), (4, 6), (4, 10), (5, 6), (5, 10), (5, 16), (6, 16),
    (8, 30), (8, 32), (8, 33), (9, 33), (13, 33), (14, 32), (14, 33),
    (15, 32), (15, 33), (18, 32), (18, 33), (19, 33), (20, 32), (20, 33),
    (22, 32), (22, 33), (23, 25), (23, 27), (23, 29), (23, 32), (23, 33),
    (24, 25), (24, 27), (24, 31), (25, 31), (26, 29), (26, 33), (27, 33),
    (28, 31), (28, 33), (29, 32), (29, 33), (30, 32), (30, 33), (31, 32),
    (31, 33), (32, 33),
)

KERNELS = (
    # name, ops module, source, the TPU kernel it replaces
    ("wedge_check", "wedge_check", "src/repro_torch/csrc/wedge_check.cu",
     "src/repro/kernels/wedge_check/wedge_check.py:50"),
    ("wedge_intersect", "wedge_intersect",
     "src/repro_torch/csrc/wedge_intersect.cu",
     "src/repro/kernels/wedge_intersect/wedge_intersect.py:75"),
    ("fold_count_max", "fold_scatter", "src/repro_torch/csrc/fold_scatter.cu",
     "src/repro/kernels/fold_scatter/fold_scatter.py:65"),
)


def log(*a):
    print(*a, flush=True)


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


# ---------------------------------------------------------------------------
# phase 1: environment and build


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def phase_build(torch, report):
    from repro_torch.kernels import _cuda

    log(f"python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    report["card"] = card_line()
    log(f"card: {report['card']}")
    t0 = time.perf_counter()
    secs = _cuda.build_all()
    report["build_s"] = time.perf_counter() - t0
    log(f"built {sorted(secs)} in {report['build_s']:.2f} s into "
        f"{_cuda.build_dir()}")
    for name in secs:
        text = (_cuda.build_dir() / f"{name}.log").read_text()
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  ptxas {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version on random inputs


def _u32_bits(a):
    return np.asarray(a, np.uint32).view(np.int32)


def _sorted_keys(rng, n):
    d = rng.integers(0, 6, n).astype(np.int32)
    h = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    h[: n // 4] = rng.integers(0, 4, n // 4).astype(np.uint32) * 0x40000000
    i = rng.permutation(n).astype(np.int32)
    order = np.lexsort((i, h, d))
    return d[order], h[order], i[order]


def wedge_check_inputs(rng, S, E, B, dev, torch):
    keys = [_sorted_keys(rng, E) for _ in range(S)]
    kd = np.stack([k[0] for k in keys])
    kh = np.stack([k[1] for k in keys])
    ki = np.stack([k[2] for k in keys])
    lo = rng.integers(0, E + 1, (S, B)).astype(np.int32)
    hi = np.minimum(lo + rng.integers(0, E, (S, B)), E).astype(np.int32)
    hi[:, ::7] = lo[:, ::7]                       # empty rows
    pick = rng.integers(0, E, (S, B))
    qd = np.take_along_axis(kd, pick, 1)
    qh = np.take_along_axis(kh, pick, 1)
    qi = np.take_along_axis(ki, pick, 1)
    qi[:, ::3] = rng.integers(0, E, (S, B))[:, ::3]
    qh[:, ::5] = rng.integers(0, 2**32, (S, B), dtype=np.uint64)[:, ::5].astype(np.uint32)
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    return (t(kd), t(_u32_bits(kh)), t(ki), t(lo), t(hi), t(qd),
            t(_u32_bits(qh)), t(qi))


def wedge_intersect_inputs(rng, E, B, Lr, L, dev, torch):
    kd, kh, ki = _sorted_keys(rng, E)
    e = rng.integers(-2, E + 2, B).astype(np.int32)
    ln = rng.integers(0, Lr + 1, B).astype(np.int32)
    ln[::5] = 0                                   # empty rows
    rd = np.full((B, Lr), 2**30, np.int32)
    rh = np.full((B, Lr), 0xFFFFFFFF, np.uint32)
    ri = np.full((B, Lr), 2**30, np.int32)
    for b in range(B):
        n = int(ln[b])
        sel = np.sort(rng.choice(E, n, replace=False))
        rd[b, :n], rh[b, :n], ri[b, :n] = kd[sel], kh[sel], ki[sel]
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    return (t(kd), t(_u32_bits(kh)), t(ki), t(e), t(rd), t(_u32_bits(rh)),
            t(ri), t(ln))


def fold_inputs(rng, B, W, cap, dev, torch):
    slots = rng.integers(-3, cap + 3, B).astype(np.int32)
    slots[::11] = -1
    amounts = rng.integers(0, 4, B).astype(np.int32)
    rows = rng.integers(0, 2**32, (B, W), dtype=np.uint64).astype(np.uint32)
    rows[::4] = 0
    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)
    return t(slots), t(amounts), t(_u32_bits(rows))


def equal_outputs(a, b, torch) -> int:
    """Max |a - b| over the outputs; raises unless exactly equal."""
    a = a if isinstance(a, tuple) else (a,)
    b = b if isinstance(b, tuple) else (b,)
    err = 0
    for x, y in zip(a, b):
        require(x.shape == y.shape and x.dtype == y.dtype,
                f"shape/dtype {x.shape} {x.dtype} vs {y.shape} {y.dtype}")
        err = max(err, int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
                  if x.numel() else 0)
    require(err == 0, f"kernel differs from its plain version by {err}")
    return err


def phase_kernels(torch, report, dev):
    from repro_torch.kernels.fold_scatter import ops as fs
    from repro_torch.kernels.wedge_check import ops as wc
    from repro_torch.kernels.wedge_intersect import ops as wi

    rng = np.random.default_rng(0)
    cases = 0
    for S, E, B in ((1, 8, 3), (3, 1000, 777), (8, 4096, 5000)):
        args = wedge_check_inputs(rng, S, E, B, dev, torch)
        equal_outputs(wc.wedge_check(*args), wc.wedge_check_plain(*args), torch)
        cases += 1
    for E, B, Lr, L in ((16, 5, 4, 9), (500, 300, 37, 50), (800, 257, 64, 64),
                        (6000, 20, 5000, 96)):
        args = wedge_intersect_inputs(rng, E, B, Lr, L, dev, torch)
        equal_outputs(wi.wedge_intersect(*args, L=L),
                      wi.wedge_intersect_plain(*args, L=L), torch)
        cases += 1
    # the last case's tables exceed shared memory: the direct path
    for B, W, cap in ((3, 5, 8), (1001, 5, 64), (100000, 5, 4096), (5000, 2, 7),
                      (50000, 5, 20000)):
        args = fold_inputs(rng, B, W, cap, dev, torch)
        equal_outputs(fs.fold_count_max(*args, cap),
                      fs.fold_count_max_plain(*args, cap), torch)
        cases += 1
    sync(torch, dev)
    report["kernel_cases"] = cases
    log(f"kernels: {cases} random/edge cases, each kernel == its plain version")


# ---------------------------------------------------------------------------
# phase 3: small main path, card == CPU port == oracle


def phase_small(torch, report, dev):
    from repro_torch.core.dodgr import shard_dodgr
    from repro_torch.core.engine import survey_push_only, survey_push_pull
    from repro_torch.core.pushpull import plan_engine
    from repro_torch.core.ref import count_triangles_ref
    from repro_torch.core.surveys import DegreeTriples, TriangleCount, ceil_log2_f32
    from repro_torch.graphs import generators
    from repro_torch.graphs.csr import HostGraph

    d = torch.as_tensor(np.concatenate(
        [(1 << k) + np.arange(-4096, 4097) for k in range(1, 31)]
        + [np.arange(2**31 - 4096, 2**31)]).astype(np.int32))
    require(torch.equal(ceil_log2_f32(d.to(dev)).cpu(), ceil_log2_f32(d)),
            "DegreeTriples degree bins differ between the card and the CPU")
    e = np.array(KARATE_EDGES, np.int64)
    graphs = {
        "karate": HostGraph.from_edges(34, e[:, 0], e[:, 1]),
        "clique8": generators.clique(8),
        "rmat9": generators.rmat(9, 16, seed=0),
    }
    runs = 0
    t0 = time.perf_counter()
    for gname, g in graphs.items():
        g = g.with_degree_meta()
        t_ref = count_triangles_ref(g)
        for S in (1, 4):
            gr_gpu, _ = shard_dodgr(g, S, device=dev)
            gr_cpu, _ = shard_dodgr(g, S, device="cpu")
            for transport in ("dense", "ragged"):
                for mode, fn in (("push", survey_push_only),
                                 ("pushpull", survey_push_pull)):
                    for survey in (TriangleCount(), DegreeTriples(capacity=4096)):
                        cfg, _ = plan_engine(g, S, survey, mode=mode,
                                             push_cap=256, pull_q_cap=8,
                                             transport=transport)
                        res_g, st_g = fn(gr_gpu, survey, cfg)
                        res_c, st_c = fn(gr_cpu, survey, cfg)
                        tag = f"{gname} S={S} {transport} {mode} {type(survey).__name__}"
                        require(res_g == res_c, f"{tag}: card result != CPU result")
                        require(st_g == st_c, f"{tag}: card stats != CPU stats")
                        require(st_g["exact"], f"{tag}: inexact")
                        if isinstance(survey, TriangleCount):
                            require(res_g == t_ref, f"{tag}: {res_g} != oracle {t_ref}")
                        else:
                            total = sum(res_g["counts"].values()) + res_g["count_in_collided"]
                            require(total == t_ref, f"{tag}: DegreeTriples total {total} != {t_ref}")
                        runs += 1
        log(f"small: {gname} ({g.n} vertices, {g.m} edges, {t_ref} triangles) ok")
    report["small_runs"] = runs
    report["small_s"] = time.perf_counter() - t0
    log(f"small: {runs} runs, card == CPU == oracle, {report['small_s']:.1f} s")


# ---------------------------------------------------------------------------
# phase 4: the full-size deployment through the user entry points


class Recorder:
    """Wraps a kernel wrapper to keep the operands of its first call and of
    its largest call (by operand size) — the inputs of one superstep of the
    run. The wrapped function still counts its launches. It pins those
    operands, so it wraps no run whose peak memory is read."""

    def __init__(self, module, name, torch):
        self.module, self.name, self.torch = module, name, torch
        self.fn = getattr(module, name)
        self.first = self.largest = None
        setattr(module, name, self)

    def size(self, args) -> int:
        return sum(a.numel() for a in args if isinstance(a, self.torch.Tensor))

    def __call__(self, *args, **kw):
        if self.first is None and args[0].numel():
            self.first = (args, kw)
        if self.largest is None or self.size(args) >= self.size(self.largest[0]):
            self.largest = (args, kw)
        return self.fn(*args, **kw)

    def restore(self):
        setattr(self.module, self.name, self.fn)


def phase_full(torch, report, scale, dev):
    from repro_torch.core.dodgr import shard_dodgr
    from repro_torch.core.engine import survey_push_only, survey_push_pull
    from repro_torch.core.pushpull import plan_engine
    from repro_torch.core.surveys import DegreeTriples, TriangleCount
    from repro_torch.graphs import generators
    from repro_torch.kernels.fold_scatter import ops as fs
    from repro_torch.kernels.wedge_check import ops as wc
    from repro_torch.kernels.wedge_intersect import ops as wi

    S = 8
    full = report["full"] = dict(scale=scale, edge_factor=16, S=S,
                                 transport="dense", push_cap=4096,
                                 pull_q_cap=16)
    t0 = time.perf_counter()
    g = generators.rmat(scale, 16, seed=0, a=0.57, b=0.19, c=0.19).with_degree_meta()
    full["gen_s"] = time.perf_counter() - t0
    full["vertices"], full["edges"] = g.n, g.m
    sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gr, rstats = shard_dodgr(g, S, device=dev)
    sync(torch, dev)
    full["shard_s"] = time.perf_counter() - t0
    full["wedges_total"] = rstats.wedges_total
    full["e_cap"], full["d_plus_max"] = gr.e_cap, gr.d_plus_max
    log(f"full: rmat{scale} {g.n} vertices {g.m} edges, |W+|={rstats.wedges_total}, "
        f"e_cap={gr.e_cap} d+max={gr.d_plus_max}; gen {full['gen_s']:.1f} s "
        f"shard {full['shard_s']:.1f} s")

    plans = {}
    for sname, survey in (("TriangleCount", TriangleCount()),
                          ("DegreeTriples", DegreeTriples(capacity=4096))):
        for mode in ("push", "pushpull"):
            t0 = time.perf_counter()
            cfg, rep = plan_engine(g, S, survey, mode=mode, push_cap=4096,
                                   pull_q_cap=16)
            plans[(sname, mode)] = (survey, cfg, time.perf_counter() - t0)
            log(f"plan {sname} {mode}: {plans[(sname, mode)][2]:.1f} s, "
                f"push steps {cfg.n_push_steps}, pull steps {cfg.n_pull_steps}, "
                f"pull_edge_cap {cfg.pull_edge_cap}, pull_row_cap {cfg.pull_row_cap}")

    # the main path: counts to 0 just before, read just after
    for mod in (wc, wi, fs):
        mod.launches = 0
    results = {}
    runs = full["runs"] = {}
    for (sname, mode), (survey, cfg, plan_s) in plans.items():
        fn = survey_push_only if mode == "push" else survey_push_pull
        sync(torch, dev)
        t0 = time.perf_counter()
        res, st = fn(gr, survey, cfg)
        sync(torch, dev)
        wall = time.perf_counter() - t0
        results[(sname, mode)] = (res, st)
        runs[f"{sname}/{mode}"] = dict(
            plan_s=plan_s, survey_s=wall, n_push_steps=cfg.n_push_steps,
            n_pull_steps=cfg.n_pull_steps, pull_edge_cap=cfg.pull_edge_cap,
            pull_row_cap=cfg.pull_row_cap, stats=st)
        log(f"survey {sname} {mode}: {wall:.2f} s, "
            f"tris push {st['tris_push']:.0f} pull {st['tris_pull']:.0f}, "
            f"exact {st['exact']}")
    launches = {"wedge_check": wc.launches, "wedge_intersect": wi.launches,
                "fold_count_max": fs.launches}
    full["launches"] = launches
    full["max_memory_allocated"] = (torch.cuda.max_memory_allocated()
                                    if dev.type == "cuda" else 0)

    tc_push = results[("TriangleCount", "push")][0]
    tc_pp = results[("TriangleCount", "pushpull")][0]
    require(tc_push == tc_pp, f"push {tc_push} != push-pull {tc_pp}")
    for mode in ("push", "pushpull"):
        dt = results[("DegreeTriples", mode)][0]
        total = sum(dt["counts"].values()) + dt["count_in_collided"]
        require(total == tc_push, f"DegreeTriples {mode} total {total} != {tc_push}")
    for key, (_, st) in results.items():
        require(st["exact"], f"{key} inexact")
    for name, n in launches.items():
        require(n > 0, f"{name} never launched on the main path")
    full["triangles"] = tc_push
    log(f"full: {tc_push} triangles; launches {launches}; peak memory "
        f"{full['max_memory_allocated'] / 2**30:.2f} GiB")
    if dev.type == "cuda":
        survey, cfg, _ = plans[("TriangleCount", "pushpull")]
        full["profile"] = profile_run(torch, lambda: survey_push_pull(gr, survey, cfg))

    # capture one superstep's inputs of each kernel (DegreeTriples push-pull
    # runs all three), then each kernel against its plain version on them
    recs = [Recorder(wc, "wedge_check", torch),
            Recorder(wi, "wedge_intersect", torch),
            Recorder(fs, "fold_count_max", torch)]
    survey, cfg, _ = plans[("DegreeTriples", "pushpull")]
    require(survey_push_pull(gr, survey, cfg)[0] == results[("DegreeTriples", "pushpull")][0],
            "capture run differs from the main path's")
    for r in recs:
        r.restore()
    captured = {
        "wedge_check": (recs[0].largest, wc.wedge_check, wc.wedge_check_plain),
        "wedge_intersect": (recs[1].largest, wi.wedge_intersect,
                            wi.wedge_intersect_plain),
        "fold_count_max": (recs[2].largest, fs.fold_count_max,
                           fs.fold_count_max_plain),
    }
    errs = {}
    for name, ((args, kw), kern, plain) in captured.items():
        errs[name] = equal_outputs(kern(*args, **kw), plain(*args, **kw), torch)
    equal_outputs(fs.fold_count_max(*recs[2].first[0], **recs[2].first[1]),
                  fs.fold_count_max_plain(*recs[2].first[0], **recs[2].first[1]),
                  torch)
    sync(torch, dev)
    log("full: each kernel == its plain version on captured superstep inputs")
    return captured, launches, errs


def profile_run(torch, fn, top=10) -> dict:
    """Device time by kernel over one run (torch.profiler, CUDA activity
    only): busy time, wall time, idle share, the heaviest kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    out = dict(wall_s=wall, device_busy_s=busy,
               idle_share=(1 - busy / wall) if busy else None,
               top=[dict(kernel=k[:120], ms=us / 1e3, count=c)
                    for us, c, k in rows[:top]])
    log(f"profile TriangleCount pushpull: wall {wall:.2f} s, device busy "
        f"{busy:.2f} s, idle share {out['idle_share']}")
    for r in out["top"]:
        log(f"  {r['ms']:10.1f} ms  x{r['count']:<7} {r['kernel']}")
    return out


# ---------------------------------------------------------------------------
# phase 5: timing at the captured shapes


def time_ms(torch, fn, reps=20, warmup=3) -> float:
    """Median device time of one call, by CUDA events. A spin kernel
    keeps the card busy while the host enqueues every call, so the events
    time the calls back to back on the device and not the host's
    wrapper overhead."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(200_000_000)
    ev[0].record()
    for i in range(reps):
        fn()
        ev[i + 1].record()
    ev[-1].synchronize()
    return statistics.median(ev[i].elapsed_time(ev[i + 1]) for i in range(reps))


def _probed(torch, keys_d, keys_h, keys_i, lo, hi, qd, qh, qi, steps):
    """Mark every key a lower-bound search of the queries reads. Keys are
    [R, N] (R searched arrays); queries [R, Q]. Returns the [R, N] bool
    marks and the number of probes (one per query per step it takes)."""
    kh_k, qh_k = keys_h ^ INT32_MIN, qh ^ INT32_MIN
    R, N = keys_d.shape
    seen = torch.zeros(R * N, dtype=torch.bool, device=keys_d.device)
    row0 = torch.arange(R, device=keys_d.device)[:, None] * N
    probes = 0
    for _ in range(steps):
        has = lo < hi
        probes += int(has.sum())
        mid = torch.where(has, (lo + hi) // 2, 0).clamp(0, N - 1).long()
        seen[(row0 + mid)[has]] = True
        d = torch.gather(keys_d, 1, mid)
        h = torch.gather(kh_k, 1, mid)
        i = torch.gather(keys_i, 1, mid)
        less = (d < qd) | ((d == qd) & (h < qh_k)) | ((d == qd) & (h == qh_k) & (i < qi))
        lo = torch.where(has & less, mid.to(lo.dtype) + 1, lo)
        hi = torch.where(has & ~less, mid.to(hi.dtype), hi)
    return seen.view(R, N), probes


# integer operations per probe of a keyed lower bound: the midpoint, the
# three-field compare (three compares, two ands, two ors), the bound update
OPS_PER_PROBE = 9


def bound_work(torch, name, args, kw) -> tuple[int, int]:
    """The bytes the function must move and the operations it must do on
    this run's data. Bytes: every input word it needs read once (searches
    read only the keys they probe; dropped slots need no operands), every
    output written once. Operations: OPS_PER_PROBE for each probe a search
    takes, the clamped candidate index (three) per wedge_intersect lane,
    the range check (two) per fold element and one atomic per kept
    word."""
    from repro_torch.kernels.wedge_check.ops import lower_bound_steps

    if name == "wedge_check":
        kd, kh, ki, lo, hi, qd, qh, qi = args
        S, E = kd.shape
        B = lo.shape[-1]
        seen, probes = _probed(torch, kd, kh, ki, lo, hi, qd, qh, qi,
                               lower_bound_steps(E))
        return 4 * 6 * S * B + 12 * int(seen.sum()), OPS_PER_PROBE * probes
    if name == "wedge_intersect":
        kd, kh, ki, e, rd, rh, ri, ln = args
        L = kw["L"]
        E = kd.shape[0]
        B, Lr = rd.shape
        k = torch.arange(L, dtype=torch.int32, device=e.device)
        idx = (e[:, None] + 1 + k).clamp(0, E - 1)
        cand = torch.zeros(E, dtype=torch.bool, device=e.device)
        cand[idx.reshape(-1).long()] = True
        seen, probes = _probed(torch, rd, rh, ri, torch.zeros_like(idx),
                               ln[:, None].expand(B, L).contiguous(),
                               kd[idx.long()], kh[idx.long()], ki[idx.long()],
                               lower_bound_steps(max(L, Lr)))
        nbytes = 4 * 2 * B + 12 * int(cand.sum()) + 12 * int(seen.sum()) + 8 * B * L
        return nbytes, 3 * B * L + OPS_PER_PROBE * probes
    slots, amounts, rows, cap = args
    B, W = rows.shape
    kept = int(((slots >= 0) & (slots < cap)).sum())
    return (4 * B + 4 * kept * (1 + W) + 4 * cap * (1 + W),
            2 * B + kept * (1 + W))


def library_fold(torch, args):
    """One PyTorch scatter pair computing fold_count_max's function
    (slots remapped past the end and rows sign-flipped beforehand)."""
    slots, amounts, rows, cap = args
    W = rows.shape[-1]
    s = torch.where((slots < 0) | (slots >= cap), cap, slots).long()
    rows_k = rows ^ INT32_MIN
    idx = s[:, None].expand(-1, W)

    def run():
        count = torch.zeros(cap + 1, dtype=torch.int32, device=slots.device)
        count.scatter_add_(0, s, amounts)
        packed = torch.full((cap + 1, W), INT32_MIN, dtype=torch.int32,
                            device=slots.device)
        packed.scatter_reduce_(0, idx, rows_k, "amax")

    return run


def phase_timing(torch, report, captured, launches, errs):
    rows = []
    for name, mod, source, replaces in KERNELS:
        (args, kw), kern, plain = captured[name]
        ms = time_ms(torch, lambda: kern(*args, **kw))
        plain_ms = time_ms(torch, lambda: plain(*args, **kw), reps=5, warmup=1)
        lib_ms = (time_ms(torch, library_fold(torch, args))
                  if name == "fold_count_max" else None)
        nbytes, nops = bound_work(torch, name, args, kw)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        ops_ms = nops / PEAK_OPS_PER_S * 1e3
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=launches[name], max_abs_err=errs[name], ms=ms,
            plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
            bound_by="bytes" if bytes_ms >= ops_ms else "operations",
            library_ms=lib_ms, bytes=nbytes, operations=nops,
            bytes_ms=bytes_ms, ops_ms=ops_ms,
            shapes=[list(a.shape) if hasattr(a, "shape") else a for a in args]))
        log(f"time {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
            f"{rows[-1]['bound_ms']:.5f} ms by {rows[-1]['bound_by']}: bytes "
            f"{bytes_ms:.5f} ms, operations {ops_ms:.5f} ms; library {lib_ms}) "
            f"at {rows[-1]['shapes']}")
    report["kernels"] = rows
    return rows


# ---------------------------------------------------------------------------


def main() -> int:
    if len(sys.argv) > 1:
        print("chip_smoke: takes no arguments", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's checks need one card",
              file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT / 'src' / 'repro_torch'} is missing; run "
              "it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    report = {}
    t_start = time.perf_counter()
    phase_build(torch, report)
    phase_kernels(torch, report, dev)
    phase_small(torch, report, dev)
    captured, launches, errs = phase_full(torch, report, FULL_SCALE, dev)
    kernels_line = {"kernels": phase_timing(torch, report, captured,
                                            launches, errs)}
    report["total_s"] = time.perf_counter() - t_start
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(report, indent=1, default=str))
    log(f"total {report['total_s']:.1f} s")
    for row in kernels_line["kernels"]:
        for k in ("shapes", "bytes", "operations", "bytes_ms", "ops_ms"):
            row.pop(k)
    print(json.dumps(kernels_line))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
