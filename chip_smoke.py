#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one GPU and check them.

    python3 chip_smoke.py        # one GPU; takes no arguments

Phases (every failure ends the run with a non-zero exit):

1. ``build``   — print torch/CUDA versions and the card's name and power
   limit; build the seven CUDA kernels (five sources, one ``nvcc`` each,
   all started together) from ``src/repro_torch/csrc``.
2. ``analysis`` — the port's static verifier in process
   (``repro_torch.analysis.__main__.main([])``, ``python -m
   repro_torch.analysis``): the fold contracts and determinism verdicts
   of the 9 built-in surveys, the JAX package's plan matrix (each survey ×
   {dense, ragged, ragged+hub, mesh, dense+bucket, ragged+hub+bucket} ×
   {pushpull, push}, and delta epochs × {exact, bucket}) audited at S=4,
   and the lint of ``src/repro_torch``; each pass's line and the phase's
   wall. Any violation fails the run.
3. ``kernels`` — each kernel equals its plain PyTorch version on the card,
   on random inputs and edge cases (hashes ≥ 2³¹, empty and full rows,
   slots -1 and ≥ cap, contested slots, batches with no valid entry or
   that fill no tile, pulled rows narrower than L). wedge_intersect also
   on CSR-shaped keys (sorted vertex rows back to back, so candidate
   windows descend; repeated keys and (d, h) ties; windows clamped at both
   ends; L below 32); ring_set also with B not a multiple of 4, slot views
   whose offset breaks 16-byte alignment, every lane on one slot, a ring
   that wraps, capacity 1, and its rows as [B, 3] and as columns.
   fold_count_max also on skewed slots (a whole batch on one slot, two
   slots alternating, a Zipf draw over 300 slots), all slots dropped, zero
   amounts with non-zero rows, words 0xFFFFFFFF and 0x80000000, B of 1,
   31, 33, 2¹⁴, 2¹⁴ + 1 and 2²⁰ + 3, rows not 16-byte aligned, W of 2 and
   8, on both sides of its one-block limit (2¹⁴ elements) and on tables
   too large for shared memory; hist_add and hist_max at their four
   callers' shape classes (LocalVertexCount's 262,144 slots with repeated
   ids, MaxEdgeLabelDist's 16, ClosureTime's hot bins, LabelTripleSet's
   4,096 counts and [4,096, 5] rows), skewed (one slot, 16 slots, Zipf,
   all dropped, sums that wrap), on both sides of every batch-size limit
   between their routes that ``csrc/hist.cu`` defines, and as views whose
   offsets break 16-byte alignment; hist_max also with rows too wide for
   the fold body's stages (W = 16) and tables too large for shared
   memory; fold_count_max with rows of 15, 16 and 64 words (read where
   they lie, not staged) on both sides of its one-block limit, on tables
   too large for shared memory and on skewed slots; wedge_check also on
   CSR-shaped keys (rows of 0, 1, 31, 32, 33, 421 and 1,100 keys, (d, h)
   ties broken by id, hashes ≥ 2³¹, queries below and above every key of
   their row) and on the hub lane's operands (stable-key rows of 1 to
   25,374 keys flattened to one key row).
4. ``small``   — karate, clique(8) and rmat(9, 16) with seeded metadata and
   temporal_social(1500, 30000, seed=1), with S ∈ {1, 4}, push and
   push-pull, dense and ragged: a bundle of all eight built-in surveys
   with an Enumerate buffer small enough to wrap, push-pull with both
   pull kernels (fused and split); on the first three graphs also
   TriangleCount and DegreeTriples (the first path) and each new survey
   alone. Results and stats on the card equal the port on the CPU, and
   the triangle count equals the pure-Python oracle. The float32 bins of DegreeTriples (around every
   power of two up to 2³¹) and of ClosureTime (the 4,096 float32
   neighbours of every power of two up to 2²⁰) on the card equal the
   CPU's. The hub lane: karate, rmat(9, 16) and temporal_social(1500,
   30000) with a forced θ, the bundle of all eight, S ∈ {1, 4}, push and
   push-pull, dense and ragged, fused and split; card == CPU == oracle.
   Delta streams: tests/test_delta.py's graph in K = 4 timestamp-ordered
   batches from an empty base, the bundle of seven, push and push-pull,
   without hubs, with rebuilt hub tables and with a HubTableCache: every
   epoch's state and stats on the card equal the CPU's, and the
   rendering equals a one-shot stable-key survey and the oracle's count;
   Enumerate's rows equal the oracle's triangle set. The serve layer: a
   ``SurveyService`` on the card and one on the CPU (tests/test_delta.py's
   graph less its last 20% of edges, residents TriangleCount and
   DegreeTriples) answer a query, a coalesced query of three tenants and
   two ingested batches alike (answers, stats, tokens, counters);
   checkpoint → restore → a memo-hit query launches no kernel; a query
   thread answers while a third batch is pending, each answer equal to
   the CPU's at its epoch; a sampled (``sample_p = 0.5``, DOULION)
   push-pull TriangleCount on the card equals the CPU's; the served
   mesh: S=4 ranks (a ``RankPool`` sharing the card over gloo, and over
   nccl where there are four cards) run the same script and the sampled
   query through ``SurveyService(mesh=pool)``, equal to the card's
   stacked service and the CPU's (answers, stats, tokens, counters).
   The mesh: S=4 rank processes sharing the card
   over gloo (``repro_torch.launch.mesh``; each collective staged through
   host memory) run karate and rmat(9, 16) with seeded metadata: the
   bundle of all eight, push and push-pull, over scheduled rounds
   (ragged caps) and over uniform caps (a dense plan relabelled mesh);
   one split-lane run; a forced-θ hub cell; and a K = 2 delta stream of
   tests/test_delta.py's graph. Every rank's state, stats and result
   equal the card's stacked run and the CPU's; the bytes handed to the
   collectives, per lane and rank, reconcile with the plan's byte model
   (``repro_torch.roofline.reconcile_collectives``); every kernel
   launched in the ranks. Over nccl too, one rank per card, where there
   are four cards (otherwise one line says it was not run).
5. ``examples`` — the port's seven examples (``repro_torch.examples``:
   quickstart, closure, label, multi, hub, streaming and the GNN loop) at
   their own sizes on the card, each through ``main(device=...)``; what
   each prints and returns is held to its JAX twin's recorded lines
   (``repro_torch.examples.expected.check``): the six survey examples line
   for line, the GNN example's survey line exactly, the losses of its
   first training steps within ``expected.LOSS_TOL`` of the twin's,
   finite losses that fall and a positive triangle-feature gain (its
   training is chaotic past those steps; its final numbers, its gap to
   the twin at every step and the first step where the gap passes
   ``LOSS_TOL`` are printed). Each example's wall.
6. ``full``    — Graph500 R-MAT (a=0.57, b=0.19, c=0.19), scale 18, edge
   factor 16, seed 0; S=8 logical shards on the card, dense transport,
   ``plan_engine(..., push_cap=4096, pull_q_cap=16)``, through the user
   entry points (``shard_dodgr`` → ``plan_engine`` → ``survey_push_only``
   / ``survey_push_pull``). Ten paths, each with the launch counts set
   to 0 just before it and read just after (paths g and h: in each rank):

   a. the first slice's: degree metadata; TriangleCount and
      DegreeTriples(capacity=4096), push-pull, and push-only on the same
      R-MAT two scales smaller (16, for the script's time: push-only is
      host-bound), whose count a sparse product on the host gives. Each count is its graph's, the
      DegreeTriples totals equal it.
   b. the metadata polling path: label, degree, timestamp and timestamp
      bucket metadata (``survey_meta``), one push-pull SurveyBundle of all
      eight built-ins. Its triangle count is the known 82,824,164; every
      member's result is checked against it, Enumerate's rows and the
      top-k triangles against the edge set, the top-k weights against
      the timestamps; the plan is stamped ``bitwise`` by tracing the
      bundle's folds. Each hist_add and hist_max launch is counted, by
      power-of-two batch-size bins, for the member whose ``update`` made
      it (ClosureTime, LabelTripleSet, LocalVertexCount,
      MaxEdgeLabelDist), with host copies of each member's first call in
      each bin and of its largest call. Peak device memory is read from
      this run; a short window of it is profiled for the device's idle
      share.
   c. the split pull kernel: TriangleCount push-pull with
      ``pull_kernel="split"``, equal to the fused run in count and stats.
   d. the hub lane: path a's graph, ``plan_engine(..., hub_theta="auto",
      hub_wedge_cap=2²⁰)``, TriangleCount and DegreeTriples push-pull:
      θ, the hub set and the hub steps as planned, the hub, push and pull
      stats as planned (the float32 sums within their rounding), the
      known count, DegreeTriples equal to path a's; walls and peak memory.
   e. a delta stream under the stable key, push-only, on path a's
      push-only graph (scale 16): the edges less a seeded 0.1%
      (``numpy.random.default_rng(3)``) appended to an empty base, then
      the held-out edges, each epoch through ``plan_delta(...,
      push_cap=65536, hub_theta="auto", hub_wedge_cap=2²⁰)`` and
      ``shard_delta`` with a HubTableCache, polling TriangleCount and
      DegreeTriples. After the two epochs: the known count, DegreeTriples
      totalling it, and the epochs' tris_push + tris_hub equal to it
      (within float32 rounding).
   f. the serve layer on path a's push-only graph (scale 16, for the
      script's time): ``SurveyService(that graph
      less a seeded 0.1% as path e holds out, 8, mode="push",
      push_cap=65536, hub_theta="auto", hub_wedge_cap=2²⁰,
      cap_policy="bucket", resident={TriangleCount,
      DegreeTriples(capacity=4096)})``; a cold ``query_coalesced`` of
      TriangleCount and LocalVertexCount, the same again (a memo hit: no
      launch), the held-out edges ingested as one delta epoch, and the
      residents' answers before and after it. The first tenant equals
      the residents' count of the base and the second sums to three
      times it; after the epoch the residents hold the known count
      (DegreeTriples totalling it); 3 recompiles and 0 hits. Each
      request's wall, peak memory above what was resident, and the
      path's launches.
   g. the mesh transport: path a's shards saved once, one file per rank;
      S=8 rank processes sharing the card over gloo, each loading its
      slice: TriangleCount push-pull on a ``transport="mesh"`` plan
      (ragged caps in scheduled rounds, one ``batch_isend_irecv`` each)
      and DegreeTriples push-pull on path a's dense plan relabelled mesh
      (uniform caps, one ``all_to_all_single``), each rank's result equal
      to path a's bit for bit, the stats within their float32 rounding
      of the plan, the bytes handed to the collectives reconciled per
      lane with the plan's byte model (``reconcile_collectives``: each
      lane == the plan's sent bytes, no rank over the schedule's
      per-device bytes, the padding per lane printed). Spawn and set-up
      seconds, each survey's wall, the largest rank's peak memory, the
      seconds in the collectives and in the staging copies, and the
      launches summed over the ranks (each rank's counts set to 0 just
      before each survey and read just after). Over nccl too, one rank per card, where there are eight
      cards; otherwise one line says it was not run and how many cards
      there are.
   h. the served mesh: path f's service, graph and requests again with
      ``mesh=`` a ``RankPool`` of eight long-lived ranks sharing the card
      over gloo (over nccl too where there are eight cards): the parent
      plans and shards on the host, each cache entry's slices stay
      resident on the ranks, each traversal (the residents' warm-up, the
      cold query, the epoch) runs there. Every answer, the residents'
      state, each memoized state and the cache and ingest counters equal
      path f's bit for bit (stats within float32 rounding); the memo hit
      sends the pool no job; each traversal's bytes reconcile with its
      plan per lane; the ranks hold exactly the cache's entries at the
      end. Each request's wall, the pool's ready seconds, the slowest
      rank's collective and staging seconds per traversal, the largest
      rank's peak and the launches over the ranks.
   i. the paper's downstream loop (its §1: triangle counts as features
      for a GNN) at full width: ``repro_torch.examples.
      triangle_features_gnn.run`` on path a's graph and shards — a
      push-pull LocalVertexCount survey (path a's plan parameters) whose
      counts equal path b's bundle member bit for bit, then SchNet at
      ``configs/schnet.py``'s published widths (3 interactions, 64 wide,
      300 Gaussian bases, cutoff 10; 2 or 3 node features, 2 classes)
      trained full batch over all 7,611,176 directed edges by the port's
      ``adamw(5e-3)`` and ``make_train_step``, ``DOWNSTREAM_STEPS`` steps
      on degree features and as many with the triangle feature. Losses
      finite and falling (the median of the last ten steps' below the
      first's). The first step with the triangle feature is held to
      float64 on the card (``downstream_witness``): its loss, its
      gradient against float64 central differences of the loss along
      two directions (the trainer's ``grad_norm`` among them), and its
      AdamW update against AdamW restated in float64. The survey's wall,
      each step's wall, the peak device memory, both runs' losses and
      accuracies.
   j. the rest of the GNN zoo at its published widths (``path_zoo``):
      DimeNet, NequIP and EquiformerV2 at ``configs/<arch>.py``'s CONFIG
      on the JAX package's molecule cell (``launch.steps.GNN_CELL_DIMS``:
      128 graphs, 3,840 atoms, 8,192 edge slots, graph energies): a
      seeded ``radius_graph_batch`` (cutoff 5, box ``ZOO_BOX``: 75–100% of
      the slots real, checked), DimeNet's triplets of its real edges under
      the cell's cap of 32,768, weights from ``threefry.prng_key(1)``.
      Graph energies in float32 within ``ZOO_RTOL`` of the same module in
      float64 on the card, and of the energies of positions under a seeded
      rotation; EquiformerV2 with ``edge_chunks = 8`` within it of 1; ten
      AdamW(1e-3) steps of the energy loss through ``make_train_step``
      (finite losses; the first and median step walls, the peak, model
      TFLOP/s from ``launch.steps.gnn_flops``); one profiled step a model
      (the device's idle share). It launches no kernel of ours (checked).

   Every run is exact and every kernel of a path launched on it. Every
   plan a path runs is audited by ``repro_torch.analysis.check_plan``
   (routing maps injective, every fed slot received, a bucketed plan the
   exact plan rounded up, the ``VolumeReport`` reconciled word for word):
   a's four, b's bundle, c's split lane, d's two hub plans, e's two
   ``plan_delta`` epochs, each plan in f's and h's service plan caches,
   g's mesh plan, and g's relabelled plan as the dense plan it is, with the mesh
   exchanges its caps build; each audit's seconds on a line of its own,
   and any violation fails the run. A capture run (DegreeTriples and
   Enumerate bundled, on path a's graph) and path c keep one superstep's operands of each kernel, on which each
   kernel equals its plain version; on the counting-set operands
   ``hist_add`` and ``hist_max`` equal their plain versions and together
   equal ``fold_count_max``. On path a, fold_count_max's launches are
   counted by batch size in power-of-two bins, and the first call in the
   bin with the most launches is kept (on the host) as its typical fold.
7. ``timing`` — the time of each kernel at those captured shapes
   (median of CUDA-event times), its plain version's, its bound, a library call's where one
   computes the same function, and one ``kernels`` JSON line; hist_add and
   hist_max have a row for each caller's modal fold (the first call in
   its bin with the most launches) and, where at least four times larger,
   its largest fold, each equal to its plain version, ranked by launches ×
   (ms − bound); and one at DegreeTriples' largest fold (a shape no real
   call has, kept for comparison with earlier runs); each kernel of paths
   d, e and f at each lane's largest launch (wedge_check's push lane and
   hub search apart), with the lane's launches there; wedge_check and
   wedge_intersect at rank 0's largest launch on path g, with path g's
   launches; fold_count_max on path a's largest fold with rows of 16
   words (no real call); every row with the kernel's launches on each
   path a–j (path j: 0). On lines before the
   JSON: wedge_intersect at the fullest and at the last pull superstep,
   the fold_count_max launch bins, and the same measures of
   fold_count_max at its typical fold.

The last line of standard output is ``{"ok": true, "device": {...}}``.
Details go to ``build/chip_smoke.json``. The script imports nothing
of JAX; it needs ``src/repro_torch`` beside it.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib
import json
import re
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FULL_SCALE = 18                # R-MAT scale of the full-size deployment
FULL_TRIANGLES = 82_824_164    # its triangle count (the cell's known count)
# path a's push-only runs, path e's delta stream and path f's service run
# on the same R-MAT this many scales below the deployment, for the
# script's time (its limit is the same while paths are added): their
# push-only supersteps are host-bound
CUT_SCALES = 2
PROFILE_PULL_STEPS = 16        # pull supersteps in a profiled window
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
    # name, ops module, its launch counter, source, the TPU kernel it replaces
    ("wedge_check", "wedge_check", "launches",
     "src/repro_torch/csrc/wedge_check.cu",
     "src/repro/kernels/wedge_check/wedge_check.py:50"),
    ("wedge_intersect", "wedge_intersect", "launches",
     "src/repro_torch/csrc/wedge_intersect.cu",
     "src/repro/kernels/wedge_intersect/wedge_intersect.py:75"),
    ("fold_count_max", "fold_scatter", "launches",
     "src/repro_torch/csrc/fold_scatter.cu",
     "src/repro/kernels/fold_scatter/fold_scatter.py:65"),
    ("ring_set", "fold_scatter", "ring_set_launches",
     "src/repro_torch/csrc/fold_scatter.cu",
     "src/repro/kernels/fold_scatter/fold_scatter.py:122"),
    ("intersect", "intersect", "launches", "src/repro_torch/csrc/intersect.cu",
     "src/repro/kernels/intersect/intersect.py:51"),
    ("hist_add", "hist", "hist_add_launches", "src/repro_torch/csrc/hist.cu",
     "src/repro/kernels/hist/hist.py:37"),
    ("hist_max", "hist", "hist_max_launches", "src/repro_torch/csrc/hist.cu",
     "src/repro/kernels/hist/hist.py:74"),
)

# the surveys of the bundle path that call each hist kernel (their updates
# fold through it)
HIST_CALLERS = {"hist_add": ("ClosureTime", "LabelTripleSet",
                             "LocalVertexCount", "MaxEdgeLabelDist"),
                "hist_max": ("LabelTripleSet",)}

# the kernels each full-size path must launch, and the path whose count
# the kernels line reports
PATH_KERNELS = {
    "first": ("wedge_check", "wedge_intersect", "fold_count_max"),
    "bundle": ("wedge_check", "wedge_intersect", "fold_count_max",
               "ring_set", "hist_add", "hist_max"),
    "split": ("wedge_check", "intersect"),
    "hub": ("wedge_check", "wedge_intersect", "fold_count_max"),
    "delta": ("wedge_check", "fold_count_max"),
    "served": ("wedge_check", "fold_count_max", "hist_add"),
    "mesh": ("wedge_check", "wedge_intersect", "fold_count_max"),
    "served_mesh": ("wedge_check", "fold_count_max", "hist_add"),
    "downstream": ("wedge_check", "wedge_intersect", "hist_add"),
    "zoo": (),
}
# the letters PERF.md gives the full-size paths
PATH_LETTERS = {"first": "a", "bundle": "b", "split": "c", "hub": "d",
                "delta": "e", "served": "f", "mesh": "g", "served_mesh": "h",
                "downstream": "i", "zoo": "j"}
REPORTED_PATH = {"wedge_check": "first", "wedge_intersect": "first",
                 "fold_count_max": "first", "ring_set": "bundle",
                 "hist_add": "bundle", "hist_max": "bundle",
                 "intersect": "split"}


def log(*a):
    print(*a, flush=True)


def require(cond, what):
    if not cond:
        raise AssertionError(what)


def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


def _ops(mod: str):
    return importlib.import_module(f"repro_torch.kernels.{mod}.ops")


def reset_launches():
    for _, mod, counter, _, _ in KERNELS:
        setattr(_ops(mod), counter, 0)


def read_launches() -> dict:
    return {name: getattr(_ops(mod), counter)
            for name, mod, counter, _, _ in KERNELS}


def same(a, b) -> bool:
    """Survey results or stats equal exactly: dicts, tuples, numpy arrays
    (dtype, shape and bytes) and scalars."""
    if isinstance(a, dict):
        return (isinstance(b, dict) and a.keys() == b.keys()
                and all(same(a[k], b[k]) for k in a))
    if isinstance(a, (tuple, list)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same(x, y) for x, y in zip(a, b)))
    if isinstance(a, np.ndarray):
        return (isinstance(b, np.ndarray) and a.dtype == b.dtype
                and a.shape == b.shape and a.tobytes() == b.tobytes())
    return a == b


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
# phase 2: the static verifier


def phase_analysis(torch, report):
    """``python -m repro_torch.analysis`` in process: its three passes
    (fold contracts, the plan matrix, the lint) must find nothing."""
    import io

    from repro_torch.analysis.__main__ import main as analysis_main

    out = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(out):
        rc = analysis_main([])
    wall = time.perf_counter() - t0
    lines = out.getvalue().strip().splitlines()
    report["analysis"] = dict(rc=rc, wall_s=wall, lines=lines)
    for line in lines:
        log(f"analysis: {line}")
    log(f"analysis: {wall:.2f} s")
    require(rc == 0, f"python -m repro_torch.analysis exited {rc}")


def audit_plan(full, tag, cfg, rep):
    """``check_plan`` on a plan a path runs, timed; any violation fails the
    run. A dense plan relabelled mesh (its report is the dense plan's) is
    audited as the dense plan it is, and the mesh exchanges its caps build
    (push and pull lanes, with their round schedules) on their own."""
    from repro_torch.analysis import (check_exchange, check_plan,
                                      check_schedule, format_report)
    from repro_torch.comm.exchange import make_exchange

    t0 = time.perf_counter()
    if cfg.transport == "mesh" and rep.transport != "mesh":
        v = check_plan(dataclasses.replace(cfg, transport=rep.transport), rep)
        lanes = [("push", cfg.push_cap, cfg.push_caps)]
        if cfg.n_pull_steps:
            lanes.append(("pull", cfg.pull_q_cap, cfg.pull_caps))
        for lane, cap, caps in lanes:
            x = make_exchange("mesh", rep.S, cap, caps)
            v += check_exchange(x, lane) + check_schedule(x.schedule, x.caps,
                                                          lane)
    else:
        v = check_plan(cfg, rep)
    wall = time.perf_counter() - t0
    full.setdefault("audits", {})[tag] = wall
    log(f"audit {tag}: {len(v)} violation(s) in {wall:.3f} s")
    require(not v, f"audit {tag}: {format_report(v)}")


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version on random inputs


def _u32_bits(a):
    return np.asarray(a, np.uint32).view(np.int32)


def _sorted_keys(rng, n):
    d = rng.integers(0, 6, n).astype(np.int32)
    h = rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32)
    h[: n // 4] = rng.integers(0, 4, n // 4).astype(np.uint32) * 0x40000000
    i = rng.permutation(n).astype(np.int32)
    order = np.lexsort((i, h, d))
    return d[order], h[order], i[order]


def _tensors(torch, dev, *arrays):
    return tuple(torch.as_tensor(np.ascontiguousarray(a), device=dev)
                 for a in arrays)


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
    return _tensors(torch, dev, kd, _u32_bits(kh), ki, lo, hi, qd,
                    _u32_bits(qh), qi)


def _padded_rows(rng, kd, kh, ki, ln, width):
    """Rows of sorted keys with valid prefix ``ln``, padded to ``width``
    with the owner's sentinels."""
    B = len(ln)
    rd = np.full((B, width), 2**30, np.int32)
    rh = np.full((B, width), 0xFFFFFFFF, np.uint32)
    ri = np.full((B, width), 2**30, np.int32)
    for b in range(B):
        n = int(ln[b])
        sel = np.sort(rng.choice(len(kd), n, replace=False))
        rd[b, :n], rh[b, :n], ri[b, :n] = kd[sel], kh[sel], ki[sel]
    return rd, rh, ri


def wedge_intersect_inputs(rng, E, B, Lr, L, dev, torch):
    kd, kh, ki = _sorted_keys(rng, E)
    e = rng.integers(-2, E + 2, B).astype(np.int32)
    ln = rng.integers(0, Lr + 1, B).astype(np.int32)
    ln[::5] = 0                                   # empty rows
    rd, rh, ri = _padded_rows(rng, kd, kh, ki, ln, Lr)
    return _tensors(torch, dev, kd, _u32_bits(kh), ki, e, rd, _u32_bits(rh),
                    ri, ln)


def intersect_inputs(rng, B, L, dev, torch):
    """Rows of length ln (0 and L among them); candidates from the rows'
    key pool or off it, a third with hashes ≥ 2³¹."""
    kd, kh, ki = _sorted_keys(rng, 4 * L)
    ln = rng.integers(0, L + 1, B).astype(np.int32)
    ln[::4] = 0
    ln[1::4] = L
    rd, rh, ri = _padded_rows(rng, kd, kh, ki, ln, L)
    pick = rng.integers(0, 4 * L, (B, L))
    qd, qh, qi = kd[pick], kh[pick], ki[pick]
    qh[:, ::3] = rng.integers(2**31, 2**32, (B, L), dtype=np.uint64)[:, ::3].astype(np.uint32)
    qi[:, 1::5] = rng.integers(0, 4 * L, (B, L))[:, 1::5]
    return _tensors(torch, dev, rd, _u32_bits(rh), ri, ln, qd, _u32_bits(qh),
                    qi)


def fold_inputs(rng, B, W, cap, dev, torch):
    slots = rng.integers(-3, cap + 3, B).astype(np.int32)
    slots[::11] = -1
    amounts = rng.integers(0, 4, B).astype(np.int32)
    rows = rng.integers(0, 2**32, (B, W), dtype=np.uint64).astype(np.uint32)
    rows[::4] = 0
    return _tensors(torch, dev, slots, amounts, _u32_bits(rows))


def skewed_fold_inputs(rng, case, B, W, cap, dev, torch):
    """Skewed and edge-case fold_count_max operands
    (``fold_scatter/ref.py``)."""
    from repro_torch.kernels.fold_scatter.ref import skewed_fold_inputs

    slots, amounts, rows = skewed_fold_inputs(rng, case, B, W, cap)
    return _tensors(torch, dev, slots, amounts, _u32_bits(rows))


def csr_wedge_check_inputs(rng, S, B, dev, torch):
    """Push queries on CSR-shaped keys (``wedge_check/ref.py``)."""
    from repro_torch.kernels.wedge_check.ref import csr_wedge_check_inputs

    kd, kh, ki, lo, hi, qd, qh, qi = csr_wedge_check_inputs(rng, S, B)
    return _tensors(torch, dev, kd, _u32_bits(kh), ki, lo, hi, qd,
                    _u32_bits(qh), qi)


def hub_wedge_check_inputs(rng, n_rows, B, dev, torch):
    """Hub-lane queries in one flattened key row (``wedge_check/ref.py``)."""
    from repro_torch.kernels.wedge_check.ref import hub_wedge_check_inputs

    kd, kh, ki, lo, hi, qd, qh, qi = hub_wedge_check_inputs(rng, n_rows, B)
    return _tensors(torch, dev, kd, _u32_bits(kh), ki, lo, hi, qd,
                    _u32_bits(qh), qi)


def csr_wedge_intersect_inputs(rng, E, B, Lr, L, dev, torch):
    """Keys laid out as a shard's CSR slots (sorted vertex rows back to
    back, repeated keys), so candidate windows descend at row boundaries;
    ln 0 and Lr; e clamped at both ends."""
    from repro_torch.kernels.wedge_intersect.ref import csr_shaped_inputs

    kd, kh, ki, e, rd, rh, ri, ln = csr_shaped_inputs(rng, E, B, Lr, L)
    return _tensors(torch, dev, kd, _u32_bits(kh), ki, e, rd, _u32_bits(rh),
                    ri, ln)


def ring_inputs(rng, B, cap, case, dev, torch):
    """Contested slots (a quarter of the table), every lane on one slot,
    a ring that wraps (more in-range lanes than cap, every fifth lane
    dropped at cap, as Enumerate's invalid lanes are), slots -1 and ≥ cap
    mixed in, or a batch with no valid entry."""
    if case == "contested":
        slots = rng.integers(0, max(1, cap // 4), B)
    elif case == "one_slot":
        slots = np.full(B, cap // 2)
    elif case == "wrap":
        slots = np.arange(B) % cap
        slots[::5] = cap
    elif case == "none_valid":
        slots = np.where(rng.random(B) < 0.5, -1, cap + rng.integers(0, 3, B))
    else:
        slots = rng.integers(-2, cap + 3, B)
        slots[::5] = -1
        slots[1::7] = cap
    rows = rng.integers(0, 2**31 - 1, (B, 3))
    prior = rng.integers(-1, 1000, (cap, 3))
    return _tensors(torch, dev, prior.astype(np.int32), slots.astype(np.int32),
                    rows.astype(np.int32))


def fold_limits() -> dict:
    """The batch-size limits between the routes (``k*MaxB``) that the
    fold launchers define."""
    csrc = ROOT / "src" / "repro_torch" / "csrc"
    text = "".join((csrc / f).read_text() for f in ("hist.cu", "fold_scatter.cu"))
    return {m[1]: int(m[2]) for m in
            re.finditer(r"constexpr long long (k\w+MaxB) = (\d+);", text)}


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
    from repro_torch.kernels.hist import ops as hist
    from repro_torch.kernels.intersect import ops as isx
    from repro_torch.kernels.wedge_check import ops as wc
    from repro_torch.kernels.wedge_intersect import ops as wi

    rng = np.random.default_rng(0)
    cases = 0
    for S, E, B in ((1, 8, 3), (3, 1000, 777), (8, 4096, 5000)):
        args = wedge_check_inputs(rng, S, E, B, dev, torch)
        equal_outputs(wc.wedge_check(*args), wc.wedge_check_plain(*args), torch)
        cases += 1
    # CSR-shaped rows; B not a multiple of 32 and more queries than a wave
    for S, B in ((1, 35), (2, 1000), (8, 33), (8, 40001)):
        args = csr_wedge_check_inputs(rng, S, B, dev, torch)
        equal_outputs(wc.wedge_check(*args), wc.wedge_check_plain(*args), torch)
        cases += 1
    # globally sorted keys, then CSR-shaped ones (L below 32 and not a
    # multiple of 4, rows narrower and wider than L, more edges than the
    # persistent grid has warps); Lr = 5000 rows exceed eight warps'
    # shared memory: the device-memory path
    for make, E, B, Lr, L in (
            (wedge_intersect_inputs, 16, 5, 4, 9),
            (wedge_intersect_inputs, 500, 300, 37, 50),
            (wedge_intersect_inputs, 800, 257, 64, 64),
            (wedge_intersect_inputs, 6000, 20, 5000, 96),
            (csr_wedge_intersect_inputs, 40, 9, 6, 7),
            (csr_wedge_intersect_inputs, 2000, 300, 64, 29),
            (csr_wedge_intersect_inputs, 5000, 200, 130, 133),
            (csr_wedge_intersect_inputs, 3000, 2500, 33, 45),
            (csr_wedge_intersect_inputs, 20000, 4000, 421, 421),
            (csr_wedge_intersect_inputs, 6000, 20, 5000, 96)):
        args = make(rng, E, B, Lr, L, dev, torch)
        equal_outputs(wi.wedge_intersect(*args, L=L),
                      wi.wedge_intersect_plain(*args, L=L), torch)
        cases += 1
    # the last case's tables exceed shared memory: the direct path
    for B, W, cap in ((3, 5, 8), (1001, 5, 64), (100000, 5, 4096), (5000, 2, 7),
                      (50000, 5, 20000)):
        args = fold_inputs(rng, B, W, cap, dev, torch)
        equal_outputs(fs.fold_count_max(*args, cap),
                      fs.fold_count_max_plain(*args, cap), torch)
        slots, amounts, rows = args
        equal_outputs(hist.hist_add(slots, amounts, cap),
                      hist.hist_add_plain(slots, amounts, cap), torch)
        equal_outputs(hist.hist_max(slots, rows, cap),
                      hist.hist_max_plain(slots, rows, cap), torch)
        cases += 3
    # skewed and edge cases on both sides of the one-block limit (2¹⁴);
    # cap 50,000 exceeds shared memory: device atomics at every B
    for case, B, W, cap in (
            ("one_slot", 100000, 5, 4096), ("one_slot", 5000, 5, 4096),
            ("alternating", 70001, 5, 4096), ("alternating", 999, 5, 4096),
            ("zipf", 2**20 + 3, 5, 4096), ("zipf", 3000, 5, 4096),
            ("dropped", 100000, 5, 4096), ("dropped", 40, 5, 4096),
            ("zero_amounts", 200000, 5, 4096), ("zero_amounts", 77, 5, 4096),
            ("extreme_words", 150000, 5, 4096), ("extreme_words", 33, 5, 64),
            ("zipf", 1, 5, 4096), ("uniform", 31, 5, 4096),
            ("uniform", 33, 5, 4096), ("zipf", 100003, 2, 4096),
            ("uniform", 100000, 8, 1024), ("zipf", 2**20 + 3, 5, 50000),
            ("zipf", 5000, 5, 50000), ("zipf", 2**14, 5, 4096),
            ("zipf", 2**14 + 1, 5, 4096)):
        args = skewed_fold_inputs(rng, case, B, W, cap, dev, torch)
        equal_outputs(fs.fold_count_max(*args, cap),
                      fs.fold_count_max_plain(*args, cap), torch)
        cases += 1
    # rows that do not start on 16 bytes (a view one row in)
    for B in (100000, 5000):
        slots, amounts, rows = skewed_fold_inputs(rng, "zipf", B + 1, 5, 4096,
                                                  dev, torch)
        args = (slots[1:], amounts[1:], rows[1:])
        equal_outputs(fs.fold_count_max(*args, 4096),
                      fs.fold_count_max_plain(*args, 4096), torch)
        cases += 1
    # a table too wide for shared memory (LocalVertexCount's), few slots
    # (MaxEdgeLabelDist's), and a batch that hits nothing
    for B, cap in ((200000, 262144), (300000, 16), (1000, 0)):
        slots, amounts, _ = fold_inputs(rng, B, 1, max(cap, 1), dev, torch)
        equal_outputs(hist.hist_add(slots, amounts, cap),
                      hist.hist_add_plain(slots, amounts, cap), torch)
        cases += 1
    # the hist callers' shape classes (LocalVertexCount's 262,144 slots
    # with repeated ids, MaxEdgeLabelDist's 16, ClosureTime's hot bins,
    # LabelTripleSet's count and [4,096, 5] rows), skewed, on both sides of
    # each limit between the routes (one block, the first port's kernels,
    # blocks; device atomics, then table slices for LocalVertexCount's
    # table); the last B of each list also as views one element in, whose
    # offsets break 16-byte alignment
    lim = fold_limits()
    la, ka = lim["kAddSingleMaxB"], lim["kAddKeptMaxB"]
    wa, lm = lim["kAddDirectMaxB"], lim["kMaxSingleMaxB"]
    for case, cap, sizes in (
            ("repeated_ids", 262144, (1, 2**14, wa, wa + 1)),
            ("one_slot", 262144, (2**14, wa + 1)),
            ("uniform", 262144, (2**14, wa + 1)),
            ("sixteen", 16, (33, la, la + 1, ka, ka + 1)),
            ("one_slot", 16, (1, la, la + 1, ka + 1)),
            ("zipf", 16, (la + 1, ka + 1)),
            ("dropped", 16, (la, ka + 1)),
            ("hot_bins", 4096, (1000, la, la + 1, ka, ka + 1)),
            ("zipf", 4096, (31, la, la + 1, ka, 2**20 + 3)),
            ("one_slot", 4096, (la, la + 1, ka + 1)),
            ("dropped", 4096, (77, ka + 1)),
            ("wrap", 4096, (la, la + 1, ka + 1)),
            ("uniform", 4096, (33, la + 1, ka + 1))):
        for B in sizes:
            slots, amounts, _ = skewed_fold_inputs(rng, case, B + 1, 1, cap,
                                                   dev, torch)
            views = [(slots[:B], amounts[:B])]
            if B == sizes[-1]:
                views.append((slots[1:], amounts[1:]))
            for s_, a_ in views:
                equal_outputs(hist.hist_add(s_, a_, cap),
                              hist.hist_add_plain(s_, a_, cap), torch)
                cases += 1
    # hist_max: LabelTripleSet's [4,096, 5] rows, W of 2 and 8, and rows too
    # wide for the fold body's stages (W = 16: the first port's shared
    # kernel where the table fits in shared memory, its device-atomic one
    # where it does not) and tables too large for shared memory, at both
    # sides of the one-block limit
    for case, W, sizes, *rest in (
            ("zipf", 5, (1, 33, lm, lm + 1, 2**20 + 3)),
            ("one_slot", 5, (lm, lm + 1, 300001)),
            ("extreme_words", 5, (77, lm + 1)),
            ("dropped", 5, (lm, 200001)),
            ("sixteen", 5, (lm + 1,)),
            ("uniform", 2, (lm, lm + 1)), ("uniform", 8, (1000, 70001)),
            ("zipf", 16, (33, lm, lm + 1), 1024),
            ("one_slot", 16, (lm, 100001), 1024),
            ("zipf", 16, (1000, lm, 70001), 4096),
            ("zipf", 5, (lm, lm + 1, 300001), 50000),
            ("dropped", 16, (lm,), 50000)):
        cap = rest[0] if rest else 4096
        for B in sizes:
            slots, _, rows = skewed_fold_inputs(rng, case, B + 1, W, cap,
                                                dev, torch)
            views = [(slots[:B], rows[:B])]
            if B == sizes[-1]:
                views.append((slots[1:], rows[1:]))
            for s_, r_ in views:
                equal_outputs(hist.hist_max(s_, r_, cap),
                              hist.hist_max_plain(s_, r_, cap), torch)
                cases += 1
    # rows as [B, 3], as its strided columns and as separate columns; the
    # slots also as views whose storage offset breaks 16-byte alignment
    for B, cap, case in ((3, 8, "mixed"), (5000, 64, "contested"),
                         (300000, 2**20, "mixed"), (1000, 40, "none_valid"),
                         (100000, 1000, "contested"), (1003, 64, "mixed"),
                         (100001, 37, "one_slot"), (5002, 64, "wrap"),
                         (777, 1, "mixed"), (4099, 1, "wrap")):
        prior, slots, rows = ring_inputs(rng, B, cap, case, dev, torch)
        want = fs.ring_set_plain(prior, slots, rows, cap)
        cols = tuple(c.contiguous() for c in rows.unbind(1))
        equal_outputs(fs.ring_set_plain(prior, slots, cols, cap), want, torch)
        for r in (rows, rows.unbind(1), cols):
            equal_outputs(fs.ring_set(prior, slots, r, cap), want, torch)
        for off in (1, 2, 3):
            view = torch.cat([slots.new_full((off,), -1), slots])[off:]
            equal_outputs(fs.ring_set(prior, view, cols, cap), want, torch)
        cases += 1
    # fold_count_max with rows of 15 words or more, read where they lie:
    # both sides of the one-block limit, tables too large for shared memory
    # (W = 16 at 4,096 slots, W = 64 at 1,024 and 50,000), skewed slots,
    # and rows that do not start on 16 bytes
    for case, B, W, cap in (
            ("zipf", 2**14, 15, 1024), ("zipf", 2**14 + 1, 15, 1024),
            ("one_slot", 5000, 16, 1024), ("zipf", 2**14, 16, 1024),
            ("zipf", 2**14 + 1, 16, 1024), ("alternating", 70001, 16, 1024),
            ("dropped", 3000, 16, 1024), ("extreme_words", 20001, 16, 1024),
            ("zipf", 100003, 16, 4096), ("one_slot", 3000, 16, 4096),
            ("zipf", 2**14, 64, 16), ("zipf", 2**14 + 1, 64, 16),
            ("uniform", 70001, 64, 1024), ("zipf", 5000, 64, 50000)):
        slots, amounts, rows = skewed_fold_inputs(rng, case, B + 1, W, cap,
                                                  dev, torch)
        for args in ((slots[:B], amounts[:B], rows[:B]),
                     (slots[1:], amounts[1:], rows[1:])):
            equal_outputs(fs.fold_count_max(*args, cap),
                          fs.fold_count_max_plain(*args, cap), torch)
            cases += 1
    # wedge_check on the hub lane's operands: the hub table flattened to
    # one key row of stable-key rows of 1 to 25,374 keys
    for n_rows, B in ((5, 1000), (64, 2**20)):
        args = hub_wedge_check_inputs(rng, n_rows, B, dev, torch)
        equal_outputs(wc.wedge_check(*args), wc.wedge_check_plain(*args), torch)
        cases += 1
    # L = 5000 rows exceed 48 KB of shared memory: the device-memory search
    for B, L in ((4, 16), (300, 37), (1000, 421), (7, 5000)):
        args = intersect_inputs(rng, B, L, dev, torch)
        equal_outputs(isx.intersect(*args), isx.intersect_plain(*args), torch)
        cases += 1
    sync(torch, dev)
    report["kernel_cases"] = cases
    log(f"kernels: {cases} random/edge cases, each kernel == its plain version")


# ---------------------------------------------------------------------------
# surveys and metadata of the slices' paths


def survey_meta(g, seed: int):
    """The metadata the bundle polls: vertex int (label, degree), edge int
    tsbucket, edge float ts. A graph that carries temporal_social's label
    and ts keeps them; otherwise labels are uniform in [0, 16) (its
    community labels) and timestamps uniform in [0, 1e6) (its t_max),
    drawn with ``numpy.random.default_rng(seed)``. The bucket is
    int32(ts / max(ts) · 15), as the JAX package's multi-survey bench
    makes it."""
    from repro_torch.graphs.csr import HostGraph, MetaSpec

    if g.spec.v_int == ("label",) and g.spec.e_float == ("ts",):
        label, ts = g.vmeta_i[:, 0], g.emeta_f[:, 0]
    else:
        rng = np.random.default_rng(seed)
        label = rng.integers(0, 16, g.n).astype(np.int32)
        ts = rng.random(g.m, dtype=np.float32) * np.float32(1e6)
    tsb = (ts / ts.max() * 15).astype(np.int32)
    spec = MetaSpec(v_int=("label",), e_int=("tsbucket",), e_float=("ts",))
    return HostGraph(g.n, g.src, g.dst, spec, label[:, None], None,
                     tsb[:, None], ts[:, None]).with_degree_meta()


def new_surveys(n: int, enum_cap: int) -> dict:
    """The six surveys this slice ported, at the columns of survey_meta;
    LabelTripleSet takes the counting set's unfused backend (hist_add +
    hist_max), DegreeTriples the fused one."""
    from repro_torch.core import surveys as sv

    return {
        "LocalVertexCount": sv.LocalVertexCount(n),
        "ClosureTime": sv.ClosureTime(ts_col=0),
        "MaxEdgeLabelDist": sv.MaxEdgeLabelDist(16),
        "LabelTripleSet": sv.LabelTripleSet(capacity=4096,
                                            counting_backend="scatter"),
        "Enumerate": sv.Enumerate(capacity=enum_cap),
        "TopKWeightedTriangles": sv.TopKWeightedTriangles(k=32),
    }


def bundle_of_all(n: int, enum_cap: int):
    from repro_torch.core import surveys as sv

    m = new_surveys(n, enum_cap)
    return sv.SurveyBundle([
        sv.TriangleCount(), m["LocalVertexCount"], m["ClosureTime"],
        m["MaxEdgeLabelDist"], sv.DegreeTriples(deg_col=1, capacity=4096),
        m["LabelTripleSet"], m["Enumerate"], m["TopKWeightedTriangles"]])


def counting_total(res) -> int:
    return sum(res["counts"].values()) + res["count_in_collided"]


# ---------------------------------------------------------------------------
# phase 4: small paths, card == CPU port == oracle


def _float_sweep(k_max: int) -> np.ndarray:
    """The 4,096 float32 neighbours on each side of every power of two up
    to 2^k_max, and the powers themselves."""
    out = []
    for k in range(k_max + 1):
        p = np.float32(2.0**k)
        up = p + np.arange(4097, dtype=np.float32) * np.spacing(p)
        down = p - np.arange(1, 4097, dtype=np.float32) * np.spacing(p / 2)
        out += [up, down]
    return np.concatenate(out).astype(np.float32)


def phase_small(torch, report, dev):
    from repro_torch.core.dodgr import shard_dodgr
    from repro_torch.core.engine import survey_push_only, survey_push_pull
    from repro_torch.core.pushpull import plan_engine
    from repro_torch.core.ref import count_triangles_ref
    from repro_torch.core.surveys import (ClosureTime, DegreeTriples,
                                          TriangleCount, ceil_log2_f32)
    from repro_torch.graphs import generators
    from repro_torch.graphs.csr import HostGraph

    d = torch.as_tensor(np.concatenate(
        [(1 << k) + np.arange(-4096, 4097) for k in range(1, 31)]
        + [np.arange(2**31 - 4096, 2**31)]).astype(np.int32))
    require(torch.equal(ceil_log2_f32(d.to(dev)).cpu(), ceil_log2_f32(d)),
            "DegreeTriples degree bins differ between the card and the CPU")
    dt = torch.as_tensor(_float_sweep(20))
    ct = ClosureTime()
    require(torch.equal(ct._bucket(dt.to(dev)).cpu(), ct._bucket(dt)),
            "ClosureTime bins differ between the card and the CPU")
    e = np.array(KARATE_EDGES, np.int64)
    graphs = {
        # name: graph, push_cap, pull_q_cap, whether the first path's
        # surveys and each new survey alone run on it too (temporal_social
        # runs the bundle alone, with wider caps, so that its long streams
        # take fewer supersteps)
        "karate": (HostGraph.from_edges(34, e[:, 0], e[:, 1]), 256, 8, True),
        "clique8": (generators.clique(8), 256, 8, True),
        "rmat9": (generators.rmat(9, 16, seed=0), 256, 8, True),
        "social": (generators.temporal_social(1500, 30000, seed=1), 4096, 32,
                   False),
    }
    runs = 0
    t0 = time.perf_counter()
    modes = (("push", "auto", survey_push_only),
             ("pushpull", "fused", survey_push_pull),
             ("pushpull", "split", survey_push_pull))
    for gname, (g, push_cap, pull_q_cap, every) in graphs.items():
        g_deg = g.with_degree_meta()
        g_lab = survey_meta(g, seed=2)
        t_ref = count_triangles_ref(g_deg)
        for S in (1, 4):
            shards = {name: (shard_dodgr(gg, S, device=dev)[0],
                             shard_dodgr(gg, S, device="cpu")[0])
                      for name, gg in (("deg", g_deg), ("lab", g_lab))}
            for transport in ("dense", "ragged"):
                for mode, kernel, fn in modes:
                    cases = [("lab", bundle_of_all(g.n, enum_cap=32))]
                    if every and kernel != "split":
                        cases += [("deg", TriangleCount()),
                                  ("deg", DegreeTriples(capacity=4096))]
                    if every and (S, transport, kernel) == (4, "dense", "fused"):
                        cases += [("lab", s) for s in
                                  new_surveys(g.n, enum_cap=32).values()]
                    for meta, survey in cases:
                        gg = g_deg if meta == "deg" else g_lab
                        cfg, _ = plan_engine(gg, S, survey, mode=mode,
                                             push_cap=push_cap,
                                             pull_q_cap=pull_q_cap,
                                             transport=transport)
                        cfg = dataclasses.replace(cfg, pull_kernel=kernel)
                        gr_gpu, gr_cpu = shards[meta]
                        res_g, st_g = fn(gr_gpu, survey, cfg)
                        res_c, st_c = fn(gr_cpu, survey, cfg)
                        tag = (f"{gname} S={S} {transport} {mode} {kernel} "
                               f"{type(survey).__name__}")
                        require(same(res_g, res_c), f"{tag}: card result != CPU result")
                        require(st_g == st_c, f"{tag}: card stats != CPU stats")
                        require(st_g["exact"], f"{tag}: inexact")
                        if isinstance(survey, TriangleCount):
                            require(res_g == t_ref, f"{tag}: {res_g} != oracle {t_ref}")
                        elif isinstance(survey, DegreeTriples):
                            total = counting_total(res_g)
                            require(total == t_ref, f"{tag}: DegreeTriples total {total} != {t_ref}")
                        elif "TriangleCount" in getattr(survey, "names", ()):
                            require(res_g["TriangleCount"] == t_ref,
                                    f"{tag}: bundle count != oracle {t_ref}")
                            require(res_g["Enumerate"]["total_found"] == t_ref,
                                    f"{tag}: Enumerate total != oracle {t_ref}")
                        runs += 1
        log(f"small: {gname} ({g.n} vertices, {g.m} edges, {t_ref} triangles) ok")
    report["small_runs"] = runs
    report["small_s"] = time.perf_counter() - t0
    log(f"small: {runs} runs, card == CPU == oracle, {report['small_s']:.1f} s")


# the small hub-lane runs: graph: (forced θ, hub_wedge_cap, push_cap,
# pull_q_cap); and (S, transport, mode, pull kernel) of each run, so that
# each graph runs both S, both modes, both transports and both kernels
SMALL_HUB = {"karate": (9, 8, 256, 8), "rmat9": (90, 256, 256, 8),
             "social": (200, 1024, 4096, 32)}
SMALL_HUB_RUNS = ((1, "dense", "push", "auto"), (1, "ragged", "pushpull", "fused"),
                  (4, "dense", "pushpull", "fused"), (4, "ragged", "pushpull", "split"),
                  (4, "ragged", "push", "auto"))
SMALL_DELTA_THETA = 25   # the small delta streams' forced hub threshold


def phase_small_hub(torch, report, dev):
    """The hub lane on karate, rmat(9, 16) and temporal_social(1500,
    30000): the bundle of all eight with a forced θ; card == CPU ==
    oracle, and the hub lane closed triangles."""
    from repro_torch.core.dodgr import shard_dodgr
    from repro_torch.core.engine import survey_push_only, survey_push_pull
    from repro_torch.core.pushpull import plan_engine
    from repro_torch.core.ref import count_triangles_ref
    from repro_torch.graphs import generators
    from repro_torch.graphs.csr import HostGraph

    e = np.array(KARATE_EDGES, np.int64)
    graphs = {"karate": HostGraph.from_edges(34, e[:, 0], e[:, 1]),
              "rmat9": generators.rmat(9, 16, seed=0),
              "social": generators.temporal_social(1500, 30000, seed=1)}
    t0 = time.perf_counter()
    runs = 0
    for gname, g in graphs.items():
        theta, hub_cap, push_cap, pull_q_cap = SMALL_HUB[gname]
        g_lab = survey_meta(g, seed=2)
        t_ref = count_triangles_ref(g_lab)
        shards = {}
        for S, transport, mode, kernel in SMALL_HUB_RUNS:
            if S not in shards:
                shards[S] = tuple(shard_dodgr(g_lab, S, hub_theta=theta,
                                              device=d)[0]
                                  for d in (dev, "cpu"))
            survey = bundle_of_all(g.n, enum_cap=32)
            cfg, _ = plan_engine(g_lab, S, survey, mode=mode,
                                 push_cap=push_cap, pull_q_cap=pull_q_cap,
                                 transport=transport, hub_theta=theta,
                                 hub_wedge_cap=hub_cap)
            cfg = dataclasses.replace(cfg, pull_kernel=kernel)
            fn = survey_push_only if mode == "push" else survey_push_pull
            (res_g, st_g), (res_c, st_c) = (fn(gr, survey, cfg)
                                            for gr in shards[S])
            tag = f"hub {gname} θ={theta} S={S} {transport} {mode} {kernel}"
            require(same(res_g, res_c), f"{tag}: card result != CPU result")
            require(st_g == st_c, f"{tag}: card stats != CPU stats")
            require(st_g["exact"], f"{tag}: inexact")
            require(shards[S][0].n_hubs > 1 and cfg.n_hub_steps > 1
                    and st_g["tris_hub"] > 0, f"{tag}: the hub lane closed nothing")
            require(res_g["TriangleCount"] == t_ref
                    and res_g["Enumerate"]["total_found"] == t_ref,
                    f"{tag}: count != oracle {t_ref}")
            runs += 1
        log(f"small hub: {gname} θ={theta}, {shards[4][0].n_hubs} hubs at "
            f"S=4, ok")
    report["small_hub_runs"] = runs
    report["small_hub_s"] = time.perf_counter() - t0
    log(f"small hub: {runs} runs, card == CPU == oracle, "
        f"{report['small_hub_s']:.1f} s")


def delta_test_graph(n: int, m: int, seed: int):
    """tests/test_delta.py's graph: temporal_social with the final graph's
    degree as a second vertex column and an int edge label (id mod 7)."""
    from repro_torch.graphs import generators
    from repro_torch.graphs.csr import HostGraph, MetaSpec

    g = generators.temporal_social(n, m, seed=seed)
    spec = MetaSpec(v_int=g.spec.v_int + ("degree",), e_int=("elabel",),
                    e_float=g.spec.e_float)
    deg = g.degrees().astype(np.int32)[:, None]
    return HostGraph(g.n, g.src, g.dst, spec,
                     np.concatenate([g.vmeta_i, deg], 1), None,
                     (np.arange(g.m, dtype=np.int32) % 7)[:, None], g.emeta_f)


def delta_bundle(n: int):
    """tests/test_delta.py's bundle of seven: every built-in whose epochs
    accumulate bit for bit."""
    from repro_torch.core import surveys as sv

    return sv.SurveyBundle([
        sv.TriangleCount(), sv.ClosureTime(ts_col=0),
        sv.LabelTripleSet(v_label_col=0, capacity=1 << 12),
        sv.MaxEdgeLabelDist(n_labels=8, e_label_col=0, v_label_col=0),
        sv.DegreeTriples(deg_col=1, capacity=1 << 12),
        sv.LocalVertexCount(n), sv.TopKWeightedTriangles(k=16, weight_col=0)])


def empty_base(g):
    from repro_torch.graphs.csr import HostGraph

    empty = np.zeros(0, np.int64)
    return HostGraph(g.n, empty, empty, g.spec, g.vmeta_i, g.vmeta_f)


def append(dg_or_base, g, idx):
    return dg_or_base.append_edges(g.src[idx], g.dst[idx],
                                   emeta_i=g.emeta_i[idx],
                                   emeta_f=g.emeta_f[idx])


def phase_small_delta(torch, report, dev):
    """K = 4 timestamp-ordered batches of tests/test_delta.py's graph from
    an empty base, push and push-pull, without hubs, with rebuilt hub
    tables and with a HubTableCache: every epoch's state and stats on the
    card equal the CPU's; the rendering equals a one-shot stable-key
    survey of the union and the oracle's count. Enumerate's rows equal
    the oracle's triangle set."""
    from repro_torch.core.dodgr import HubTableCache, shard_delta, shard_dodgr
    from repro_torch.core.engine import (finalize_epochs, survey_delta,
                                         survey_push_only, survey_push_pull)
    from repro_torch.core.pushpull import plan_delta, plan_engine
    from repro_torch.core.ref import count_triangles_ref, survey_triangles_ref
    from repro_torch.core.surveys import Enumerate
    from repro_torch.interop import state_to_numpy

    t0 = time.perf_counter()
    g = delta_test_graph(120, 1200, seed=4)
    batches = np.array_split(np.argsort(g.emeta_f[:, 0], kind="stable"), 4)
    t_ref = count_triangles_ref(g)
    runs = 0

    def stream(survey, mode, hubs):
        theta = SMALL_DELTA_THETA if hubs != "none" else 0
        base = empty_base(g)
        cache = HubTableCache(base) if hubs == "cached" else None
        dg, states, hub_tris = None, [None, None], 0.0
        for k, idx in enumerate(batches):
            dg = append(dg if dg is not None else base, g, idx)
            cfg, _ = plan_delta(dg, 2, survey, mode=mode, push_cap=64,
                                pull_q_cap=4, hub_theta=theta)
            out = []
            for i, d in enumerate((dev, "cpu")):
                # one cache serves both: advance() is idempotent at an epoch
                gr, _ = shard_delta(dg, 2, hub_theta=cfg.hub_theta,
                                    hub_cache=cache, device=d)
                states[i], st = survey_delta(gr, survey, cfg, states[i])
                out.append((state_to_numpy(states[i]), st))
            tag = f"delta {mode} hubs={hubs} epoch {k + 1}"
            require(same(out[0][0], out[1][0]), f"{tag}: card state != CPU state")
            require(out[0][1] == out[1][1], f"{tag}: card stats != CPU stats")
            require(out[0][1]["exact"], f"{tag}: inexact")
            hub_tris += out[0][1]["tris_hub"]
        require(hubs == "none" or hub_tris > 0, f"{mode} {hubs}: no hub triangle")
        return dg, states[0]

    for mode in ("push", "pushpull"):
        for hubs in ("none", "rebuilt", "cached"):
            survey = delta_bundle(g.n)
            dg, state = stream(survey, mode, hubs)
            res = finalize_epochs(survey, state)
            u = dg.union()
            cfg, _ = plan_engine(u, 2, survey, mode=mode, orient="stable",
                                 push_cap=64, pull_q_cap=4)
            gr, _ = shard_dodgr(u, 2, orient="stable", device=dev)
            fn = survey_push_only if mode == "push" else survey_push_pull
            full, _ = fn(gr, survey, cfg)
            require(same(res, full), f"delta {mode} hubs={hubs}: epochs != one-shot")
            require(res["TriangleCount"] == t_ref,
                    f"delta {mode} hubs={hubs}: {res['TriangleCount']} != {t_ref}")
            runs += 1
    survey = Enumerate(capacity=4096)
    _, state = stream(survey, "pushpull", "cached")
    res = finalize_epochs(survey, state)
    oracle = set()
    survey_triangles_ref(g, lambda p, q, r, m: oracle.add((p, q, r)),
                         orient="stable")
    require(res["total_found"] == len(oracle) and res["overflowed"] == 0
            and {tuple(t) for t in res["triangles"].tolist()} == oracle,
            "delta Enumerate rows != the oracle's triangles")
    report["small_delta_streams"] = runs + 1
    report["small_delta_s"] = time.perf_counter() - t0
    log(f"small delta: {runs + 1} streams of 4 epochs, card == CPU, == "
        f"one-shot == oracle ({t_ref} triangles), "
        f"{report['small_delta_s']:.1f} s")


SMALL_SERVE = dict(hub_theta=5, push_cap=64)   # tests/test_torch_serve.py's
# the small sampled service: push-pull, dense, p = 1/2
SMALL_SAMPLED = dict(push_cap=64, pull_q_cap=4, sample_p=0.5, sample_seed=7)


def served_answer(result, stats):
    """A served answer, its stats less the wall time."""
    return result, {k: v for k, v in stats.items() if k != "plan_setup_s"}


def phase_small_serve(torch, report, dev):
    """The serve layer at the small phases' sizes: tests/test_delta.py's
    graph less its last 20% of edges by timestamp, S=4, residents
    TriangleCount and DegreeTriples, one service on the card and one on
    the CPU driven through one script: a query, a coalesced query of three
    tenants and two ingested batches (10% each), whose answers, stats,
    tokens and counters on the card equal the CPU's; checkpoint → restore
    → a memo-hit query that launches no kernel; and a query thread
    answering while a third batch is pending, each answer from a whole
    snapshot and equal to the CPU's at its epoch. Then a sampled query
    (the first DOULION run on the card), card == CPU, and the script and
    the sampled query again over four ranks of a ``RankPool``, equal to
    the card's stacked service."""
    import threading

    from repro_torch.core.ref import count_triangles_ref
    from repro_torch.core.surveys import (ClosureTime, DegreeTriples,
                                          LocalVertexCount, TriangleCount)
    from repro_torch.graphs.csr import HostGraph
    from repro_torch.serve import SurveyService, TenantRequest

    t0 = time.perf_counter()
    g = delta_test_graph(120, 1200, seed=4)
    order = np.argsort(g.emeta_f[:, 0], kind="stable")
    cut = int(g.m * 0.8)
    b = order[:cut]
    base = HostGraph(g.n, g.src[b], g.dst[b], g.spec, g.vmeta_i, g.vmeta_f,
                     g.emeta_i[b], g.emeta_f[b])
    batches = np.array_split(order[cut:], 3)
    reqs = [TenantRequest("t0", TriangleCount()),
            TenantRequest("t1", ClosureTime(ts_col=0)),
            TenantRequest("t2", LocalVertexCount(g.n))]
    out_dir = ROOT / "build" / "serve_small"
    out_dir.mkdir(parents=True, exist_ok=True)

    def script(d, mesh=None):
        svc = SurveyService(base, 4, device=d, mesh=mesh, **SMALL_SERVE,
                            resident={"tc": TriangleCount(),
                                      "dt": DegreeTriples(deg_col=1)})
        log_ = [served_answer(*svc.query(DegreeTriples(deg_col=1)))]
        out = svc.query_coalesced(reqs)
        log_.append({t: served_answer(*out[t]) for t in out})
        for idx in batches[:2]:
            append(svc, g, idx)
            svc.flush()
            st = svc.ingest_stats()
            log_.append((svc.snapshot.token, svc.resident_answers(),
                         {k: st[k] for k in st if not k.startswith("apply_s")}))
        log_.append(served_answer(*svc.query(TriangleCount())))
        return svc, log_

    svc, on_card = script(dev)
    cpu, on_cpu = script("cpu")
    require(same(on_card, on_cpu), "small serve: card answers != CPU answers")
    u = svc.snapshot.union
    require(on_card[-1][0] == count_triangles_ref(u) == on_card[-2][1]["tc"],
            "small serve: served count != the oracle's")
    require(on_card[-1][1]["exact"], "small serve: inexact")

    # restart: the memoized answer without a kernel launch
    path = str(out_dir / "ckpt.npz")
    svc.checkpoint(path)
    restored = SurveyService.restore(path, 4, device=dev, **SMALL_SERVE)
    sync(torch, dev)
    before = read_launches()
    res, st = restored.query(TriangleCount())
    sync(torch, dev)
    restored.close()
    require(read_launches() == before, "small serve: the restored memo "
            "hit launched a kernel")
    require(res == on_card[-1][0] and st["served_from"] == "memo"
            and st["plan_cache_hit"] == 1.0,
            "small serve: restore did not answer from the memo")

    # queries from a second thread while the third batch is pending
    stop, seen = threading.Event(), []

    def hammer():
        while not stop.is_set():
            res, stats = svc.query(TriangleCount())
            seen.append((int(stats["served_epoch"]), res))
            time.sleep(0.001)   # leave the worker most of the interpreter

    t = threading.Thread(target=hammer)
    t.start()
    try:
        append(svc, g, batches[2])
        svc.flush()
    finally:
        stop.set()
        t.join(timeout=300)
    require(not t.is_alive(), "small serve: the query thread hangs")
    require(seen, "small serve: no query answered during the ingest")
    append(cpu, g, batches[2])
    cpu.flush()
    want = {2: on_cpu[-1][0], 3: cpu.query(TriangleCount())[0]}
    for ep, res in seen:
        require(res == want[ep], f"small serve: an answer at epoch {ep} "
                f"{res} != CPU {want[ep]} (a torn snapshot?)")
    require(same(svc.resident_answers(), cpu.resident_answers())
            and want[3] == count_triangles_ref(g),
            "small serve: residents after the third batch != CPU / oracle")
    svc.close()
    cpu.close()
    card_epochs = sorted({ep for ep, _ in seen})

    # DOULION: a sampled ad-hoc TriangleCount, card == CPU
    def sampled(d, mesh=None):
        s_svc = SurveyService(base, 4, device=d, mesh=mesh, **SMALL_SAMPLED)
        try:
            return served_answer(*s_svc.query(TriangleCount()))
        finally:
            s_svc.close()

    sampled_card = sampled(dev)
    require(same(sampled_card, sampled("cpu")),
            "small serve: the sampled answer on the card != the CPU's")
    require(sampled_card[1]["sample_p"] == SMALL_SAMPLED["sample_p"],
            "small serve: the sampled query was not sampled")
    report["small_serve"] = dict(
        epochs_queried=card_epochs, queries_during_ingest=len(seen),
        sampled=dict(count=sampled_card[0],
                     rel_stderr=sampled_card[1]["sample_rel_stderr"]))
    log(f"small serve: card == CPU (query, coalesced, 2 batches, restore "
        f"from the memo, {len(seen)} queries during a third batch at epochs "
        f"{card_epochs}; sampled p = {SMALL_SAMPLED['sample_p']}: "
        f"{sampled_card[0]} triangles, rel. stderr "
        f"{sampled_card[1]['sample_rel_stderr']:.3f})")

    # the served mesh: S=4 ranks on the card, the same script and the
    # sampled query, equal to the card's stacked service and the CPU's
    def served_mesh(backend):
        from repro_torch.launch.mesh import RankPool

        t_pool = time.perf_counter()
        with RankPool(4, backend=backend,
                      device=None if dev.type == "cuda" else "cpu",
                      timeout=600,
                      workdir=mesh_workdir("served_small") / backend) as pool:
            ready_s = max(r["ready_s"] for r in pool.ready())
            pool.log = []
            m_svc, on_mesh = script(dev, mesh=pool)
            m_svc.close()
            sampled_mesh = sampled(dev, mesh=pool)
            jobs = len(pool.log)
            launches = {k: sum(r["launches"][k] for _, recs in pool.log
                               for r in recs) for k in read_launches()}
        require(same(on_mesh, on_card),
                f"small served mesh {backend}: answers != the card's stacked "
                "service's")
        require(same(sampled_mesh, sampled_card),
                f"small served mesh {backend}: the sampled answer != the "
                "card's stacked service's")
        for k in ("wedge_check", "fold_count_max"):
            require(launches[k] > 0 or dev.type != "cuda",
                    f"small served mesh {backend}: {k} never launched")
        out = dict(seconds=time.perf_counter() - t_pool, ready_s=ready_s,
                   jobs=jobs, launches=launches)
        log(f"small served mesh: 4 ranks over {backend}, the serve script "
            f"and the sampled query == card stacked == CPU (answers, stats, "
            f"tokens, counters); ranks ready {ready_s:.1f} s, {jobs} jobs, "
            f"{out['seconds']:.1f} s; launches in the ranks {launches}")
        return out

    report["small_serve"]["mesh_gloo"] = served_mesh("gloo")
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if cards >= 4:
        report["small_serve"]["mesh_nccl"] = served_mesh("nccl")
    else:
        log(f"small served mesh: NCCL not run: {cards} card(s) seen; nccl "
            "needs one card per rank (4)")
    report["small_serve"]["seconds"] = time.perf_counter() - t0
    log(f"small serve: {report['small_serve']['seconds']:.1f} s")


# ---------------------------------------------------------------------------
# phase 5: the full-size deployment through the user entry points


# ---------------------------------------------------------------------------
# the mesh: one shard per torch.distributed rank, ranks sharing the card


MESH_SMALL_S = 4
MESH_FULL_S = 8


def mesh_workdir(name: str) -> Path:
    return ROOT / "build" / "mesh" / name


def check_mesh_bytes(tag, outs, cfg, rep, S) -> dict:
    """The bytes each rank handed to the collectives, per lane (the ranks'
    outputs ``outs`` of one job), reconciled with the plan's byte model
    (``reconcile_collectives``: each lane == the plan's sent bytes, no
    rank over the schedule's per-device bytes, nothing on an unknown
    lane; the padding where the plan's report ``rep`` is given); returns
    the reconciliation's lanes."""
    from repro_torch.roofline import reconcile_collectives

    rec = reconcile_collectives([o["bytes"] for o in outs], cfg, S=S,
                                volume=rep)
    require(rec["ok"], f"{tag}: collective bytes do not reconcile with the "
            f"plan: lanes {rec['lanes']}, unknown lanes {rec['extra_lanes']}")
    lanes = {k: r for k, r in rec["lanes"].items() if r["sent"]}
    log(f"{tag}: bytes " + "; ".join(
        f"{k} {r['measured']} == sent {r['sent']} (per device <= "
        f"{r['per_device']}, largest rank {r['rank_max']}, padding "
        f"{r.get('padding', 'not known without the plan report')})"
        for k, r in lanes.items())
        + f"; merge {rec['other_bytes']} (not reconciled)")
    return lanes


def mesh_summary(ranks, index) -> dict:
    """Per job: the wall (the slowest rank), peak memory (the largest
    rank's), seconds in collectives and in staging (the slowest rank's,
    and summed), bytes per lane and kernel launches summed over ranks."""
    out = {}
    for key, i in index.items():
        outs = [r["outputs"][i] for r in ranks]
        out[key] = dict(
            wall_s=max(o["wall_s"] for o in outs),
            peak=max(o["peak"] for o in outs),
            resident=max(o["resident"] for o in outs),
            wire_s_max=max(o["wire_s"] for o in outs),
            wire_s_sum=sum(o["wire_s"] for o in outs),
            stage_s_max=max(o["stage_s"] for o in outs),
            stage_s_sum=sum(o["stage_s"] for o in outs),
            bytes={k: sum(o["bytes"].get(k, 0) for o in outs)
                   for k in sorted({k for o in outs for k in o["bytes"]})},
            launches={k: sum(o["launches"][k] for o in outs)
                      for k in outs[0]["launches"]})
    return out


def phase_small_mesh(torch, report, dev):
    """The mesh at small sizes: karate and rmat(9, 16) with seeded
    metadata and tests/test_delta.py's graph, S=4 ranks sharing the card
    over gloo (the transport stages each collective through host memory):
    the bundle of all eight, push and push-pull, over scheduled rounds
    (ragged caps) and over uniform caps (a dense plan relabelled mesh:
    all_to_all_single); one split-lane run; a forced-θ hub cell; a K = 2
    delta stream. Each rank's result and stats equal the card's stacked
    run and the CPU's, bit for bit; the bytes handed to the collectives
    reconcile with the plan (``check_mesh_bytes``). Over nccl too, one
    rank per card, where there are four cards."""
    from repro_torch.core.dodgr import shard_delta, shard_dodgr
    from repro_torch.core.engine import (finalize_epochs, make_survey_fn,
                                         survey_delta)
    from repro_torch.core.pushpull import plan_delta, plan_engine
    from repro_torch.core.ref import count_triangles_ref
    from repro_torch.graphs import generators
    from repro_torch.graphs.csr import HostGraph
    from repro_torch.interop import state_to_numpy
    from repro_torch.launch.mesh import RankRun

    S = MESH_SMALL_S
    t0 = time.perf_counter()
    e = np.array(KARATE_EDGES, np.int64)
    graphs = {"karate": HostGraph.from_edges(34, e[:, 0], e[:, 1]),
              "rmat9": generators.rmat(9, 16, seed=0)}
    jobs, index, want = [], {}, {}

    def stacked(survey, cfg, gr_pair):
        out = []
        for gr in gr_pair:
            merged, st = make_survey_fn(survey, cfg)(gr)
            out.append((state_to_numpy(merged), st, survey.finalize(merged)))
        return out

    for gname, g in graphs.items():
        theta, hub_cap, push_cap, pull_q_cap = SMALL_HUB[gname]
        g_lab = survey_meta(g, seed=2)
        t_ref = count_triangles_ref(g_lab)
        shards = {th: tuple(shard_dodgr(g_lab, S, hub_theta=th, device=d)[0]
                            for d in (dev, "cpu")) for th in (0, theta)}
        cells = [(mode, cell, "fused") for mode in ("push", "pushpull")
                 for cell in ("ragged", "uniform")]
        cells += [("pushpull", "hub", "fused")]
        if gname == "rmat9":
            cells += [("pushpull", "ragged", "split")]
        for mode, cell, kernel in cells:
            survey = bundle_of_all(g.n, enum_cap=32)
            th = theta if cell == "hub" else 0
            kw = dict(mode=mode, push_cap=push_cap, pull_q_cap=pull_q_cap,
                      hub_theta=th, hub_wedge_cap=hub_cap)
            stk = "dense" if cell == "uniform" else "ragged"
            cfg, rep = plan_engine(g_lab, S, survey, transport=stk, **kw)
            mcfg = cfg if cell == "uniform" else plan_engine(
                g_lab, S, survey, transport="mesh", **kw)[0]
            require(dataclasses.replace(mcfg, transport=stk) == cfg,
                    f"{gname} {cell}: the mesh plan's caps != {stk}'s")
            cfg = dataclasses.replace(cfg, pull_kernel=kernel)
            mcfg = dataclasses.replace(mcfg, transport="mesh", pull_kernel=kernel)
            key = (gname, mode, cell, kernel)
            card, cpu = stacked(survey, cfg, shards[th])
            require(same(card, cpu), f"mesh {key}: stacked card != CPU")
            require(card[2]["TriangleCount"] == t_ref,
                    f"mesh {key}: stacked count != oracle {t_ref}")
            want[key] = (card, (mcfg, rep))
            index[key] = len(jobs)
            jobs.append(dict(kind="survey", gr=shards[th][1], survey=survey,
                             cfg=mcfg, entry="fn"))
    # a K = 2 delta stream, push-pull, from an empty base
    g = delta_test_graph(120, 1200, seed=4)
    batches = np.array_split(np.argsort(g.emeta_f[:, 0], kind="stable"), 2)
    survey = delta_bundle(g.n)
    dg, grs, cfgs, states, stats = None, [], [], [None, None], [[], []]
    for idx in batches:
        dg = append(dg if dg is not None else empty_base(g), g, idx)
        cfg, _ = plan_delta(dg, S, survey, mode="pushpull", push_cap=64,
                            pull_q_cap=4, transport="mesh")
        for i, d in enumerate((dev, "cpu")):
            gr, _ = shard_delta(dg, S, device=d)
            states[i], st = survey_delta(
                gr, survey, dataclasses.replace(cfg, transport="ragged"),
                states[i])
            stats[i].append(st)
        grs.append(gr)
        cfgs.append(cfg)
    card = (state_to_numpy(states[0]), stats[0], finalize_epochs(survey, states[0]))
    require(same(card, (state_to_numpy(states[1]), stats[1],
                        finalize_epochs(survey, states[1]))),
            "mesh delta: stacked card != CPU")
    require(card[2]["TriangleCount"] == count_triangles_ref(g),
            "mesh delta: stacked count != oracle")
    want[("delta",)] = (card, None)
    index[("delta",)] = len(jobs)
    jobs.append(dict(kind="delta", grs=grs, cfgs=cfgs, survey=survey))
    def run(backend):
        t_spawn = time.perf_counter()
        ranks = RankRun(S, jobs, mesh_workdir("small") / backend,
                        backend=backend,
                        device=None if dev.type == "cuda" else "cpu",
                        timeout=600).start().wait()
        spawn_s = time.perf_counter() - t_spawn
        for key, i in index.items():
            (w_state, w_stats, w_result), plan = want[key]
            outs = [r["outputs"][i] for r in ranks]
            for r, o in enumerate(outs):
                tag = f"mesh {backend} {key} rank {r}"
                require(same(o["state"], w_state), f"{tag}: state != stacked")
                require(o["stats"] == w_stats, f"{tag}: stats != stacked")
                require(same(o["result"], w_result),
                        f"{tag}: result != stacked")
            if plan is not None:
                check_mesh_bytes(f"mesh {backend} {' '.join(key)}", outs,
                                 *plan, S)
        summary = mesh_summary(ranks, index)
        launches = {k: sum(s["launches"][k] for s in summary.values())
                    for k in summary[("delta",)]["launches"]}
        for k in ("wedge_check", "wedge_intersect", "fold_count_max",
                  "ring_set", "hist_add", "hist_max", "intersect"):
            require(launches[k] > 0 or dev.type != "cuda",
                    f"small mesh {backend}: {k} never launched in the ranks")
        staged = sum(s["stage_s_sum"] for s in summary.values())
        cards = torch.cuda.device_count() if dev.type == "cuda" else 0
        where = {"nccl": "one rank per card (",
                 "gloo": f"on {min(cards, S)} card(s) (host-staged "
                 "collectives, " if cards else "on the CPU ("}[backend]
        log(f"small mesh: {len(jobs)} runs on {S} ranks over {backend} "
            f"{where}{staged:.2f} s staging over all ranks), each rank == "
            f"card stacked == CPU, bytes reconciled with the plan; spawn "
            f"{spawn_s:.1f} s "
            f"(ranks ready after {max(r['ready_s'] for r in ranks):.1f} s); "
            f"launches in the ranks {launches}")
        return dict(runs=len(jobs), spawn_s=spawn_s,
                    ready_s=[r["ready_s"] for r in ranks], launches=launches,
                    jobs={" ".join(map(str, k)): v
                          for k, v in summary.items()})

    report["small_mesh"] = run("gloo")
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if cards >= S:
        report["small_mesh_nccl"] = run("nccl")
    else:
        log(f"small mesh: NCCL not run: {cards} card(s) seen; nccl needs "
            f"one card per rank ({S})")
    report["small_mesh_s"] = time.perf_counter() - t0
    log(f"small mesh: {report['small_mesh_s']:.1f} s")


def _on(args, dev):
    return tuple(a.to(dev) if hasattr(a, "to") else a for a in args)


class LaunchBins:
    """Wraps a kernel wrapper to count its launches by batch size (the
    first operand's length) in power-of-two bins (bin k holds 2^k <= B <
    2^(k+1); a call with B = 0 launches nothing), per caller: ``caller``
    names the survey whose ``update`` is running (``tag_updates`` sets it;
    None outside). For each caller it keeps a host copy of the first
    call's operands in each bin and of its largest call: no device memory
    stays pinned. The wrapped function still counts its launches."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.fn = getattr(module, name)
        self.caller = None
        self.by_caller = {}   # caller: dict(counts, first, largest)
        setattr(module, name, self)

    def __call__(self, *args):
        B = args[0].shape[0]
        if B and args[0].device.type == "cuda":
            rec = self.by_caller.setdefault(
                self.caller, dict(counts={}, first={}, largest=None))
            k = B.bit_length() - 1
            rec["counts"][k] = rec["counts"].get(k, 0) + 1
            if k not in rec["first"]:
                rec["first"][k] = _on(args, "cpu")
            if rec["largest"] is None or B > rec["largest"][0].shape[0]:
                rec["largest"] = rec["first"][k] if (
                    rec["first"][k][0].shape[0] == B) else _on(args, "cpu")
        return self.fn(*args)

    def restore(self):
        setattr(self.module, self.name, self.fn)

    def counts(self, caller=None) -> dict:
        return self.by_caller.get(caller, {}).get("counts", {})

    def modal_bin(self, caller=None) -> int:
        """The bin with the most launches (the smaller bin on a tie)."""
        counts = self.counts(caller)
        return max(counts, key=lambda k: (counts[k], -k))

    def modal(self, dev, caller=None):
        """The first call in the modal bin, its operands on ``dev``, as
        ``(args, kw)``."""
        return _on(self.by_caller[caller]["first"][self.modal_bin(caller)],
                   dev), {}

    def largest(self, dev, caller=None):
        return _on(self.by_caller[caller]["largest"], dev), {}


@contextlib.contextmanager
def tag_updates(bundle, wrappers):
    """While a bundle member's ``update`` runs, every wrapper's ``caller``
    is the member's name."""
    for name, member in zip(bundle.names, bundle.surveys):
        def update(state, tri, _name=name, _fn=member.update):
            for w in wrappers:
                w.caller = _name
            try:
                return _fn(state, tri)
            finally:
                for w in wrappers:
                    w.caller = None
        member.update = update
    try:
        yield
    finally:
        for member in bundle.surveys:
            del member.update


def bin_labels(counts: dict) -> dict:
    return {f"2^{k}": counts[k] for k in sorted(counts)}


class Recorder:
    """Wraps a kernel wrapper to keep the operands of its first call, of
    its largest call (by operand size; the first of equal sizes, so the
    first and fullest pull superstep where every call has one size) and
    of its last call — the inputs of one superstep of the run. The wrapped
    function still counts its launches. It pins those operands, so it
    wraps no run whose peak memory is read."""

    def __init__(self, module, name, torch):
        self.module, self.name, self.torch = module, name, torch
        self.fn = getattr(module, name)
        self.first = self.largest = self.last = None
        setattr(module, name, self)

    def size(self, args) -> int:
        return sum(self.size(a) if isinstance(a, tuple) else a.numel()
                   for a in args
                   if isinstance(a, (tuple, self.torch.Tensor)))

    def __call__(self, *args, **kw):
        if self.first is None and args[0].numel():
            self.first = (args, kw)
        if self.largest is None or self.size(args) > self.size(self.largest[0]):
            self.largest = (args, kw)
        self.last = (args, kw)
        return self.fn(*args, **kw)

    def restore(self):
        setattr(self.module, self.name, self.fn)


def operand_size(args) -> int:
    return sum(operand_size(a) if isinstance(a, tuple) else a.numel()
               for a in args if isinstance(a, tuple) or hasattr(a, "numel"))


class LaneCapture:
    """Wraps a kernel wrapper to count its launches by lane (``lane_of``
    names a call's lane from its operands) and keep host copies of the
    operands of each lane's first launch and of its largest (by operand
    size; the first of equal sizes). No device memory stays pinned: the
    copies are made as the run goes, each waiting for the card, and
    ``copy_s`` sums the host time they took inside the run. The wrapped
    function still counts its launches."""

    def __init__(self, module, name, lane_of=None):
        self.module, self.name = module, name
        self.lane_of = lane_of or (lambda args: name)
        self.fn = getattr(module, name)
        self.lanes = {}     # lane: dict(launches, first, largest, size)
        self.copy_s = 0.0
        setattr(module, name, self)

    def __call__(self, *args, **kw):
        before = read_launches()[self.name]
        out = self.fn(*args, **kw)
        if read_launches()[self.name] == before:
            return out
        lane = self.lanes.setdefault(self.lane_of(args), dict(
            launches=0, first=None, largest=None, size=-1))
        lane["launches"] += 1
        size = operand_size(args)
        if size > lane["size"]:
            t0 = time.perf_counter()
            host = (_on(args, "cpu"), kw)
            self.copy_s += time.perf_counter() - t0
            lane["first"] = lane["first"] or host
            lane["largest"], lane["size"] = host, size
        return out

    def restore(self):
        setattr(self.module, self.name, self.fn)


def push_or_hub(args) -> str:
    """wedge_check's lane: the hub search has one flattened key row."""
    return "hub" if args[0].shape[0] == 1 else "push"


def capture_lanes(kernels):
    """LaneCaptures of a path's kernels (wedge_check by lane)."""
    mods = {name: mod for name, mod, *_ in KERNELS}
    return [LaneCapture(_ops(mods[k]), k,
                        push_or_hub if k == "wedge_check" else None)
            for k in kernels]


def lane_rows(path, caps, launches, dev):
    """Restore the captured wrappers; for each kernel and lane of the path,
    its launches there and the host copy of its largest launch's
    operands, as ``[dict(key, name, path, lane, launches, entry)]``."""
    for c in caps:
        c.restore()
    out = []
    for c in caps:
        require(sum(v["launches"] for v in c.lanes.values())
                == launches[path][c.name] or dev.type != "cuda",
                f"{path}: {c.name} launches not all captured")
        for lane, v in sorted(c.lanes.items()):
            out.append(dict(key=f"{c.name}_{PATH_LETTERS[path]}_{lane}",
                            name=c.name, path=path, lane=lane,
                            launches=v["launches"], entry=v["largest"]))
    return out


def copies(caps):
    return sum(c.copy_s for c in caps)


def memory_reset(torch, dev) -> int:
    """Reset the peak device memory count; returns the bytes allocated
    now (0 on the CPU)."""
    if dev.type != "cuda":
        return 0
    torch.cuda.reset_peak_memory_stats()
    return torch.cuda.memory_allocated()


def peak_memory(torch, dev) -> int:
    return torch.cuda.max_memory_allocated() if dev.type == "cuda" else 0


def f32_near(stat: float, exact: int, adds: int) -> bool:
    """A float32 stat summed from ``adds`` exact integers lies within half
    an ulp of its magnitude a sum of ``exact`` (ROADMAP Queue 3 (a))."""
    ulp = float(np.spacing(np.float32(max(exact, 1))))
    return abs(stat - exact) <= adds * ulp / 2


def run_path(torch, dev, name, fn):
    """One full-size path: launch counts set to 0 just before, read just
    after; each kernel of the path must have launched."""
    sync(torch, dev)
    reset_launches()
    out = fn()
    sync(torch, dev)
    launches = read_launches()
    for k in PATH_KERNELS[name]:
        require(launches[k] > 0, f"{k} never launched on the {name} path")
    return out, launches


class EdgeIndex:
    """Host lookup of undirected edges (and their metadata rows)."""

    def __init__(self, g):
        self.n = g.n
        key = g.src.astype(np.int64) * g.n + g.dst
        self.order = np.argsort(key, kind="stable")
        self.key = key[self.order]

    def find(self, a, b):
        """Edge rows of the pairs (a, b) and whether each exists."""
        a, b = np.asarray(a, np.int64), np.asarray(b, np.int64)
        k = np.minimum(a, b) * self.n + np.maximum(a, b)
        i = np.minimum(np.searchsorted(self.key, k), len(self.key) - 1)
        return self.order[i], self.key[i] == k

    def triangles_real(self, tri) -> bool:
        p, q, r = tri[:, 0], tri[:, 1], tri[:, 2]
        return bool(all(self.find(x, y)[1].all()
                        for x, y in ((p, q), (p, r), (q, r))))


def check_bundle(res, st, g_lab, expect: int, full: dict):
    """Each member of the full-size bundle against the count and the
    graph."""
    require(st["exact"], "bundle run inexact")
    t = res["TriangleCount"]
    require(t == expect, f"bundle TriangleCount {t} != {expect}")
    en = res["Enumerate"]
    require(en["total_found"] == t, f"Enumerate total {en['total_found']} != {t}")
    require(counting_total(res["DegreeTriples"]) == t, "DegreeTriples total != count")
    lvc = int(res["LocalVertexCount"].astype(np.int64).sum())
    require(lvc == 3 * t, f"LocalVertexCount sums to {lvc}, not 3 * {t}")
    joint = int(res["ClosureTime"]["joint"].astype(np.int64).sum())
    require(joint == t, f"ClosureTime histogram sums to {joint}, not {t}")
    mx = int(res["MaxEdgeLabelDist"].astype(np.int64).sum())
    lts = counting_total(res["LabelTripleSet"])
    require(mx == lts, f"MaxEdgeLabelDist sums to {mx}, LabelTripleSet to {lts}")
    idx = EdgeIndex(g_lab)
    tris = en["triangles"]
    require(len(tris) >= min(100_000, t), f"Enumerate holds only {len(tris)} rows")
    require(idx.triangles_real(tris), "an Enumerate row is not a triangle")
    top = res["TopKWeightedTriangles"]
    tt, w = top["triangles"], top["weights"]
    require(len(tt) == min(32, t) and idx.triangles_real(tt),
            "a top-k row is not a triangle")
    ts = g_lab.emeta_f[:, 0]
    e_pq, e_pr, e_qr = (idx.find(tt[:, i], tt[:, j])[0]
                        for i, j in ((0, 1), (0, 2), (1, 2)))
    require(np.array_equal(w, (ts[e_pq] + ts[e_pr]) + ts[e_qr]),
            "top-k weights != the float32 sums of their edges' ts")
    require(bool((np.diff(w) <= 0).all()), "top-k weights increase")
    full["bundle_checks"] = dict(
        triangles=t, enumerate_rows=int(len(tris)),
        enumerate_overflowed=en["overflowed"], lvc_sum=lvc, closure_sum=joint,
        distinct_label_triangles=mx,
        label_triples=len(res["LabelTripleSet"]["counts"]),
        label_collided_slots=res["LabelTripleSet"]["n_collided_slots"],
        top_weight=float(w[0]))


def phase_full(torch, report, scale, dev):
    from repro_torch.core.dodgr import shard_dodgr
    from repro_torch.core.engine import survey_push_only, survey_push_pull
    from repro_torch.core.pushpull import plan_engine
    from repro_torch.core.ref import count_triangles_ref
    from repro_torch.core.surveys import (DegreeTriples, Enumerate,
                                          SurveyBundle, TriangleCount)
    from repro_torch.graphs import generators
    from repro_torch.kernels.fold_scatter import ops as fs
    from repro_torch.kernels.hist import ops as hist
    from repro_torch.kernels.intersect import ops as isx
    from repro_torch.kernels.wedge_check import ops as wc
    from repro_torch.kernels.wedge_intersect import ops as wi

    S = 8
    full = report["full"] = dict(scale=scale, edge_factor=16, S=S,
                                 transport="dense", push_cap=4096,
                                 pull_q_cap=16)
    t0 = time.perf_counter()
    base = generators.rmat(scale, 16, seed=0, a=0.57, b=0.19, c=0.19)
    g = base.with_degree_meta()
    g_lab = survey_meta(base, seed=1)
    g_cut = generators.rmat(scale - CUT_SCALES, 16, seed=0, a=0.57, b=0.19,
                            c=0.19).with_degree_meta()
    full["gen_s"] = time.perf_counter() - t0
    full["vertices"], full["edges"] = g.n, g.m
    expect = FULL_TRIANGLES if scale == FULL_SCALE else count_triangles_ref(g)
    t0 = time.perf_counter()
    expect_cut = count_triangles_sparse(g_cut)
    full["cut"] = dict(scale=scale - CUT_SCALES, vertices=g_cut.n,
                       edges=g_cut.m, triangles=expect_cut,
                       count_s=time.perf_counter() - t0)
    sync(torch, dev)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gr, rstats = shard_dodgr(g, S, device=dev)
    sync(torch, dev)
    full["shard_s"] = time.perf_counter() - t0
    full["wedges_total"] = rstats.wedges_total
    full["e_cap"], full["d_plus_max"] = gr.e_cap, gr.d_plus_max
    gr_cut, _ = shard_dodgr(g_cut, S, device=dev)
    log(f"full: rmat{scale} {g.n} vertices {g.m} edges, |W+|={rstats.wedges_total}, "
        f"e_cap={gr.e_cap} d+max={gr.d_plus_max}; gen {full['gen_s']:.1f} s "
        f"shard {full['shard_s']:.1f} s; push-only runs and path e on "
        f"rmat{scale - CUT_SCALES} ({g_cut.m} edges, {expect_cut} triangles)")

    def plan(gg, survey, mode):
        t0 = time.perf_counter()
        cfg, rep = plan_engine(gg, S, survey, mode=mode, push_cap=4096,
                               pull_q_cap=16)
        return cfg, time.perf_counter() - t0, rep

    plans, reports = {}, {}
    for sname, survey in (("TriangleCount", TriangleCount()),
                          ("DegreeTriples", DegreeTriples(capacity=4096))):
        for mode in ("push", "pushpull"):
            cfg, plan_s, reports[(sname, mode)] = plan(
                g_cut if mode == "push" else g, survey, mode)
            plans[(sname, mode)] = (survey, cfg, plan_s)
            log(f"plan {sname} {mode}: {plan_s:.1f} s, "
                f"push steps {cfg.n_push_steps}, pull steps {cfg.n_pull_steps}, "
                f"pull_edge_cap {cfg.pull_edge_cap}, pull_row_cap {cfg.pull_row_cap}")
            audit_plan(full, f"a {sname} {mode}", cfg, reports[(sname, mode)])

    # path a: the first slice's four runs, push-only on the cut graph
    results = {}
    runs = full["runs"] = {}

    def first_path():
        for (sname, mode), (survey, cfg, plan_s) in plans.items():
            fn = survey_push_only if mode == "push" else survey_push_pull
            sync(torch, dev)
            t0 = time.perf_counter()
            res, st = fn(gr_cut if mode == "push" else gr, survey, cfg)
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

    launches = full["launches"] = {}
    bins = LaunchBins(fs, "fold_count_max")
    _, launches["first"] = run_path(torch, dev, "first", first_path)
    bins.restore()
    full["fold_count_max_bins"] = bin_labels(bins.counts())
    require(sum(bins.counts().values()) == launches["first"]["fold_count_max"]
            or dev.type != "cuda", "fold_count_max bins miss launches")
    full["max_memory_allocated"] = (torch.cuda.max_memory_allocated()
                                    if dev.type == "cuda" else 0)
    del gr_cut
    for mode, want in (("push", expect_cut), ("pushpull", expect)):
        tc = results[("TriangleCount", mode)][0]
        require(tc == want, f"{mode} triangle count {tc} != {want}")
        total = counting_total(results[("DegreeTriples", mode)][0])
        require(total == want, f"DegreeTriples {mode} total {total} != {want}")
    for key, (_, st) in results.items():
        require(st["exact"], f"{key} inexact")
    tc_pp = full["triangles"] = results[("TriangleCount", "pushpull")][0]
    log(f"full: {tc_pp} triangles ({expect_cut} push-only on the cut graph); "
        f"launches {launches['first']}; peak memory "
        f"{full['max_memory_allocated'] / 2**30:.2f} GiB")
    if dev.type == "cuda":
        survey, cfg, _ = plans[("TriangleCount", "pushpull")]
        window = dataclasses.replace(cfg, n_push_steps=0,
                                     n_pull_steps=PROFILE_PULL_STEPS)
        with warnings.catch_warnings():      # a window, inexact by design
            warnings.simplefilter("ignore", RuntimeWarning)
            full["profile"] = profile_run(
                torch, f"TriangleCount pushpull, {PROFILE_PULL_STEPS} pull "
                "supersteps", lambda: survey_push_pull(gr, survey, window))

    # path b: the metadata polling path, a bundle of all eight built-ins
    t0 = time.perf_counter()
    gr_lab, _ = shard_dodgr(g_lab, S, device=dev)
    sync(torch, dev)
    full["bundle_shard_s"] = time.perf_counter() - t0
    bundle = bundle_of_all(g_lab.n, enum_cap=2**20)
    cfg_b, plan_s, rep_b = plan(g_lab, bundle, "pushpull")
    audit_plan(full, "b bundle pushpull", cfg_b, rep_b)
    full["bundle_plan"] = dict(
        plan_s=plan_s, n_push_steps=cfg_b.n_push_steps,
        n_pull_steps=cfg_b.n_pull_steps, pull_edge_cap=cfg_b.pull_edge_cap,
        pull_row_cap=cfg_b.pull_row_cap, meta_widths=cfg_b.meta_widths,
        determinism=cfg_b.determinism)
    log(f"plan bundle pushpull: {full['bundle_plan']}")
    require(cfg_b.determinism == "bitwise", "bundle not stamped bitwise")
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    hist_bins = {k: LaunchBins(hist, k) for k in HIST_CALLERS}
    t0 = time.perf_counter()
    with tag_updates(bundle, list(hist_bins.values())):
        (res_b, st_b), launches["bundle"] = run_path(
            torch, dev, "bundle",
            lambda: survey_push_pull(gr_lab, bundle, cfg_b))
    full["bundle_s"] = time.perf_counter() - t0
    for b in hist_bins.values():
        b.restore()
    full["hist_bins"] = {k: {c: bin_labels(b.counts(c)) for c in b.by_caller}
                         for k, b in hist_bins.items()}
    for k, b in hist_bins.items():
        require(sorted(b.by_caller, key=str) == sorted(HIST_CALLERS[k])
                or dev.type != "cuda",
                f"{k} callers {list(b.by_caller)} != {HIST_CALLERS[k]}")
        require(sum(sum(b.counts(c).values()) for c in b.by_caller)
                == launches["bundle"][k] or dev.type != "cuda",
                f"{k} launches not all attributed to a caller")
    full["bundle_max_memory_allocated"] = (torch.cuda.max_memory_allocated()
                                           if dev.type == "cuda" else 0)
    full["bundle_stats"] = st_b
    check_bundle(res_b, st_b, g_lab, expect, full)
    log(f"survey bundle pushpull: {full['bundle_s']:.2f} s, launches "
        f"{launches['bundle']}, peak memory "
        f"{full['bundle_max_memory_allocated'] / 2**30:.2f} GiB; "
        f"checks {full['bundle_checks']}")
    if dev.type == "cuda":
        window = dataclasses.replace(cfg_b, n_push_steps=0,
                                     n_pull_steps=PROFILE_PULL_STEPS)
        with warnings.catch_warnings():      # a window, inexact by design
            warnings.simplefilter("ignore", RuntimeWarning)
            full["bundle_profile"] = profile_run(
                torch, f"bundle, {PROFILE_PULL_STEPS} pull supersteps",
                lambda: survey_push_pull(gr_lab, bundle, window))

    del gr_lab

    # path c: the split pull kernel
    survey, cfg, _ = plans[("TriangleCount", "pushpull")]
    split = dataclasses.replace(cfg, pull_kernel="split")
    audit_plan(full, "c TriangleCount pushpull split", split,
               reports[("TriangleCount", "pushpull")])
    rec_is = Recorder(isx, "intersect", torch)
    t0 = time.perf_counter()
    (res_s, st_s), launches["split"] = run_path(
        torch, dev, "split", lambda: survey_push_pull(gr, survey, split))
    full["split_s"] = time.perf_counter() - t0
    rec_is.restore()
    require(launches["split"]["wedge_intersect"] == 0,
            "the split path launched wedge_intersect")
    res_f, st_f = results[("TriangleCount", "pushpull")]
    require(res_s == res_f, f"split count {res_s} != fused {res_f}")
    require(st_s == st_f, "split stats != fused stats")
    log(f"survey TriangleCount pushpull split: {full['split_s']:.2f} s == fused; "
        f"launches {launches['split']}")

    lane_rows = paths_hub_delta(
        torch, dev, full, g, S, expect,
        results[("DegreeTriples", "pushpull")][0], launches,
        g_cut, expect_cut)
    rows_f, f_out = path_served(torch, dev, full, g_cut, S, expect_cut,
                                launches)
    lane_rows += rows_f
    lane_rows += path_mesh(torch, dev, full, g, gr, expect, plans, reports,
                           results, launches)
    path_served_mesh(torch, dev, full, g_cut, MESH_FULL_S, f_out, launches)
    path_downstream(torch, dev, full, g, gr, S, res_b["LocalVertexCount"],
                    launches)
    t0 = time.perf_counter()
    _, launches["zoo"] = run_path(torch, dev, "zoo",
                                  lambda: path_zoo(torch, dev, full))
    full["zoo"]["wall_s"] = time.perf_counter() - t0
    require(not any(launches["zoo"].values()),
            f"path j launched a kernel of the survey path: {launches['zoo']}")
    log(f"path j: {full['zoo']['wall_s']:.2f} s, no kernel of ours launched")

    # capture one superstep's inputs of each kernel: DegreeTriples and
    # Enumerate bundled on path a's graph run wedge_check, wedge_intersect,
    # fold_count_max and ring_set
    recs = [Recorder(wc, "wedge_check", torch),
            Recorder(wi, "wedge_intersect", torch),
            Recorder(fs, "fold_count_max", torch),
            Recorder(fs, "ring_set", torch)]
    survey_dt, cfg_dt, _ = plans[("DegreeTriples", "pushpull")]
    cap_bundle = SurveyBundle([survey_dt, Enumerate(capacity=2**20)])
    res_cap, _ = survey_push_pull(gr, cap_bundle, cfg_dt)
    for r in recs:
        r.restore()
    require(res_cap["DegreeTriples"] == results[("DegreeTriples", "pushpull")][0],
            "capture run's DegreeTriples differs from the first path's")
    require(same(res_cap["Enumerate"], res_b["Enumerate"]),
            "capture run's Enumerate differs from the bundle's")
    fold_args, fold_kw = recs[2].largest
    slots, amounts, rows, cap = fold_args
    captured = {
        "wedge_check": (recs[0].largest, wc.wedge_check, wc.wedge_check_plain),
        "wedge_intersect": (recs[1].largest, wi.wedge_intersect,
                            wi.wedge_intersect_plain),
        "fold_count_max": (recs[2].largest, fs.fold_count_max,
                           fs.fold_count_max_plain),
        "ring_set": (recs[3].largest, fs.ring_set, fs.ring_set_plain),
        "intersect": (rec_is.largest, isx.intersect, isx.intersect_plain),
        "hist_add": (((slots, amounts, cap), {}), hist.hist_add,
                     hist.hist_add_plain),
        "hist_max": (((slots, rows, cap), {}), hist.hist_max,
                     hist.hist_max_plain),
    }
    # paths d, e and f: each kernel's largest launch of each lane, and a fold
    # of rows of 16 words (path a's largest fold's slots)
    pairs = {"wedge_check": (wc.wedge_check, wc.wedge_check_plain),
             "wedge_intersect": (wi.wedge_intersect, wi.wedge_intersect_plain),
             "fold_count_max": (fs.fold_count_max, fs.fold_count_max_plain),
             "hist_add": (hist.hist_add, hist.hist_add_plain)}
    for r in lane_rows:
        args, kw = r.pop("entry")
        captured[r["key"]] = ((_on(args, dev), kw), *pairs[r["name"]])
    rows16 = torch.as_tensor(np.random.default_rng(5).integers(
        0, 2**32, (slots.shape[0], 16), dtype=np.uint64).astype(np.uint32)
        .view(np.int32), device=dev)
    captured["fold_count_max_w16"] = (((slots, amounts, rows16, cap), {}),
                                      fs.fold_count_max, fs.fold_count_max_plain)
    errs = {}
    for name, ((args, kw), kern, plain) in captured.items():
        errs[name] = equal_outputs(kern(*args, **kw), plain(*args, **kw), torch)
    captured["lane_rows"] = lane_rows
    for rec, kern, plain in ((recs[2], fs.fold_count_max, fs.fold_count_max_plain),
                             (recs[3], fs.ring_set, fs.ring_set_plain)):
        equal_outputs(kern(*rec.first[0], **rec.first[1]),
                      plain(*rec.first[0], **rec.first[1]), torch)
    for args in (fold_args, recs[2].first[0]):
        equal_outputs((hist.hist_add(args[0], args[1], args[3]),
                       hist.hist_max(args[0], args[2], args[3])),
                      fs.fold_count_max(*args), torch)
    # the last pull superstep's window (sparser than the fullest), timed
    # beside it
    last = recs[1].last
    equal_outputs(wi.wedge_intersect(*last[0], **last[1]),
                  wi.wedge_intersect_plain(*last[0], **last[1]), torch)
    captured["wedge_intersect_last"] = (last, wi.wedge_intersect,
                                        wi.wedge_intersect_plain)
    # each hist caller's modal fold, and its largest where that is at
    # least four times as large
    hist_calls = captured["hist_callers"] = []
    for k, b in hist_bins.items():
        kern, plain = getattr(hist, k), getattr(hist, f"{k}_plain")
        for caller in sorted(b.by_caller, key=str):
            shapes = [("modal", b.modal(dev, caller))]
            largest = b.largest(dev, caller)
            if largest[0][0].shape[0] >= 4 * shapes[0][1][0][0].shape[0]:
                shapes.append(("largest", largest))
            for which, entry in shapes:
                B = entry[0][0].shape[0]
                hist_calls.append(dict(
                    name=k, caller=caller, fold=which, batch=B,
                    bin=f"2^{B.bit_length() - 1}",
                    caller_launches=sum(b.counts(caller).values()),
                    launches_in_bin=b.counts(caller)[B.bit_length() - 1],
                    max_abs_err=equal_outputs(kern(*entry[0]),
                                              plain(*entry[0]), torch),
                    entry=(entry, kern, plain)))
    if bins.counts():
        typical = bins.modal(dev)
        errs["fold_count_max_typical"] = equal_outputs(
            fs.fold_count_max(*typical[0]), fs.fold_count_max_plain(*typical[0]),
            torch)
        captured["fold_count_max_typical"] = (typical, fs.fold_count_max,
                                              fs.fold_count_max_plain)
    sync(torch, dev)
    log("full: each kernel == its plain version on captured superstep inputs "
        "(paths d, e and f: each lane's largest launch); hist_add + hist_max == "
        "fold_count_max")
    return captured, launches, errs


def paths_hub_delta(torch, dev, full, g, S, expect, dt_pushpull, launches,
                    g_cut, expect_cut):
    """Paths d (the hub lane, push-pull) on path a's graph ``g`` and e (a
    delta stream under the stable key, push-only) on ``g_cut``, the same
    R-MAT ``CUT_SCALES`` smaller, whose count is ``expect_cut``; their launch
    counts go into ``launches``. ``dt_pushpull`` is path a's push-pull
    DegreeTriples result. Peak memory is read with path a's shards still
    resident (``resident`` says how much that is). Each kernel of each
    path is captured by lane (``LaneCapture``): returns, for each path,
    kernel and lane, its launches there and host copies of its largest
    launch's operands, as ``[dict(key, name, path, lane, launches,
    entry)]``."""
    from repro_torch.core.dodgr import HubTableCache, shard_delta, shard_dodgr
    from repro_torch.core.engine import (finalize_epochs, survey_delta,
                                         survey_push_pull)
    from repro_torch.core.pushpull import plan_delta, plan_engine
    from repro_torch.core.surveys import (DegreeTriples, SurveyBundle,
                                          TriangleCount)
    # path d: the hub lane, push-pull, with the planner's θ
    hub = full["hub"] = {}
    hub_plans, hub_shards = {}, {}
    for sname, survey in (("TriangleCount", TriangleCount()),
                          ("DegreeTriples", DegreeTriples(capacity=4096))):
        t0 = time.perf_counter()
        cfg, rep = plan_engine(g, S, survey, mode="pushpull", push_cap=4096,
                               pull_q_cap=16, hub_theta="auto",
                               hub_wedge_cap=1 << 20)
        plan_s = time.perf_counter() - t0
        if cfg.hub_theta not in hub_shards:
            t0 = time.perf_counter()
            hub_shards[cfg.hub_theta] = shard_dodgr(
                g, S, hub_theta=cfg.hub_theta, device=dev)[0]
            sync(torch, dev)
            hub[f"shard_s_theta_{cfg.hub_theta}"] = time.perf_counter() - t0
        gr_h = hub_shards[cfg.hub_theta]
        require(cfg.hub_theta == rep.hub_theta > 0
                and gr_h.n_hubs == rep.n_hubs > 0, f"{sname}: hub set != plan")
        require(cfg.n_hub_steps == -(-rep.hub_stream_max // cfg.hub_wedge_cap),
                f"{sname}: hub steps != plan")
        audit_plan(full, f"d {sname} pushpull hub", cfg, rep)
        hub_plans[sname] = (survey, cfg, rep, gr_h)
        hub[sname] = dict(
            plan_s=plan_s, hub_theta=cfg.hub_theta, n_hubs=rep.n_hubs,
            n_hub_steps=cfg.n_hub_steps, n_push_steps=cfg.n_push_steps,
            n_pull_steps=cfg.n_pull_steps, pull_edge_cap=cfg.pull_edge_cap,
            pull_row_cap=cfg.pull_row_cap,
            hub_resolved_wedges=rep.hub_resolved_wedges,
            hub_stream_max=rep.hub_stream_max,
            hub_table_bytes=rep.hub_table_bytes)
        log(f"plan hub {sname} pushpull: {hub[sname]}")

    def hub_path():
        for sname, (survey, cfg, rep, gr_h) in hub_plans.items():
            sync(torch, dev)
            resident = memory_reset(torch, dev)
            c0 = copies(caps_d)
            t0 = time.perf_counter()
            res, st = survey_push_pull(gr_h, survey, cfg)
            sync(torch, dev)
            hub[sname].update(
                survey_s=time.perf_counter() - t0, stats=st,
                capture_s=copies(caps_d) - c0,
                resident=resident, max_memory_allocated=peak_memory(torch, dev))
            tag = f"hub path {sname}"
            require(st["exact"], f"{tag}: inexact")
            require(st["tris_hub"] > 0, f"{tag}: the hub lane closed nothing")
            require(f32_near(st["wedges_hub"], rep.hub_resolved_wedges,
                             cfg.n_hub_steps), f"{tag}: hub wedges != plan")
            require(f32_near(st["wedges_pushed"], rep.pushpull_push_entries,
                             cfg.n_push_steps), f"{tag}: pushed wedges != plan")
            require(st["pull_requests"] == rep.pushpull_requests,
                    f"{tag}: pull requests != plan")
            if sname == "TriangleCount":
                require(res == expect, f"{tag}: {res} != {expect}")
            else:
                require(same(res, dt_pushpull),
                        f"{tag}: DegreeTriples != path a's push-pull")
            log(f"survey {sname} pushpull hub: {hub[sname]['survey_s']:.2f} s "
                f"({hub[sname]['capture_s']:.3f} s of it copying operands), "
                f"tris push {st['tris_push']:.0f} hub {st['tris_hub']:.0f} "
                f"pull {st['tris_pull']:.0f}, peak "
                f"{hub[sname]['max_memory_allocated'] / 2**30:.2f} GiB with "
                f"{resident / 2**30:.2f} GiB resident before")

    caps_d = capture_lanes(PATH_KERNELS["hub"])
    _, launches["hub"] = run_path(torch, dev, "hub", hub_path)
    rows = lane_rows("hub", caps_d, launches, dev)
    del hub_shards, hub_plans, gr_h

    # path e: a delta stream under the stable key, push-only: the edges
    # less a seeded 0.1% from an empty base, then the held-out edges
    delta = full["delta"] = {}
    g, expect = g_cut, expect_cut
    held, keep = held_out(g.m)
    base_e = empty_base(g)
    survey_e = SurveyBundle([TriangleCount(), DegreeTriples(capacity=4096)])
    t0 = time.perf_counter()
    cache = HubTableCache(base_e)
    delta["cache_seed_s"] = time.perf_counter() - t0
    caps_e = capture_lanes(PATH_KERNELS["delta"])

    def delta_path():
        dg, state, tris = None, None, 0.0
        adds = 0
        for ep, idx in ((1, np.flatnonzero(keep)), (2, held)):
            t0 = time.perf_counter()
            dg = append(dg if dg is not None else base_e, g, idx)
            cfg, rep = plan_delta(dg, S, survey_e, mode="push",
                                  push_cap=65536, hub_theta="auto",
                                  hub_wedge_cap=1 << 20)
            plan_s = time.perf_counter() - t0
            audit_plan(full, f"e epoch {ep} push delta", cfg, rep)
            t0 = time.perf_counter()
            gr_e, _ = shard_delta(dg, S, hub_theta=cfg.hub_theta,
                                  hub_cache=cache, device=dev)
            sync(torch, dev)
            shard_s = time.perf_counter() - t0
            require(gr_e.n_hubs == rep.n_hubs > 0 and gr_e.hub_rows == "union",
                    f"epoch {ep}: hub set != plan")
            resident = memory_reset(torch, dev)
            c0 = copies(caps_e)
            t0 = time.perf_counter()
            state, st = survey_delta(gr_e, survey_e, cfg, state)
            sync(torch, dev)
            wall = time.perf_counter() - t0
            require(st["exact"] and st["tris_hub"] > 0,
                    f"epoch {ep}: inexact or no hub triangle")
            tris += st["tris_push"] + st["tris_hub"]
            adds += cfg.n_push_steps + cfg.n_hub_steps
            delta[f"epoch_{ep}"] = dict(
                m_delta=dg.m_delta, frontier_edges=dg.frontier()[0].m,
                plan_s=plan_s, shard_s=shard_s, survey_s=wall,
                capture_s=copies(caps_e) - c0, hub_theta=cfg.hub_theta, n_hubs=rep.n_hubs,
                n_hub_steps=cfg.n_hub_steps, n_push_steps=cfg.n_push_steps,
                hub_len=gr_e.hub_len, d_plus_max=gr_e.d_plus_max,
                gen_wedges=rep.gen_wedges, cache=dict(cache.last_build),
                resident=resident, max_memory_allocated=peak_memory(torch, dev),
                stats=st)
            log(f"delta epoch {ep}: {delta[f'epoch_{ep}']}")
            del gr_e
        return finalize_epochs(survey_e, state), tris, adds

    (res_e, tris_e, adds_e), launches["delta"] = run_path(
        torch, dev, "delta", delta_path)
    rows += lane_rows("delta", caps_e, launches, dev)
    require({r["key"] for r in rows} >= {"wedge_check_d_hub",
                                         "wedge_check_e_hub"}
            or dev.type != "cuda", "no hub search was launched")
    t_e = res_e["TriangleCount"]
    require(t_e == expect, f"delta stream {t_e} != {expect}")
    dt_e = counting_total(res_e["DegreeTriples"])
    require(dt_e == expect, f"delta stream DegreeTriples total {dt_e} != {expect}")
    require(f32_near(tris_e, expect, adds_e),
            f"the epochs' tris_push + tris_hub {tris_e} != {expect}")
    delta["tris_stat_sum"] = tris_e
    log(f"delta stream: rmat{int(np.log2(g.n))}, {expect} triangles after 2 "
        f"epochs, DegreeTriples totals {dt_e}; launches {launches['delta']}")
    return rows


def count_triangles_sparse(g) -> int:
    """The triangle count of a host graph by a sparse product on the
    host, independent of the engine: orient each edge from the lower to
    the higher (degree, id), then sum (A·A) ∘ A."""
    import scipy.sparse as sp

    key = g.degrees().astype(np.int64) * g.n + np.arange(g.n)
    up = key[g.src] < key[g.dst]
    p, q = np.where(up, g.src, g.dst), np.where(up, g.dst, g.src)
    a = sp.csr_matrix((np.ones(len(p), np.int64), (p, q)), shape=(g.n, g.n))
    return int((a @ a).multiply(a).sum())


def held_out(m: int):
    """Path e's and f's seeded 0.1% of the edges: their indices, sorted,
    and the mask of the edges kept."""
    held = np.sort(np.random.default_rng(3).choice(m, m // 1000,
                                                   replace=False))
    keep = np.ones(m, bool)
    keep[held] = False
    return held, keep


def path_served(torch, dev, full, g, S, expect, launches):
    """Path f, the serve layer: a ``SurveyService`` over path a's push-only
    graph ``g`` less a seeded 0.1% of its edges (``held_out``, as path e
    holds out; push-only, the planner's hub θ, bucketed caps, residents
    TriangleCount and DegreeTriples), asked a cold coalesced query of two
    tenants (TriangleCount, LocalVertexCount), the same again (a memo hit
    that launches no kernel), then fed the held-out edges as one delta
    epoch (hub rows from its HubTableCache), and its residents' answers
    read before and after. The first tenant equals the residents' count
    of the base (two traversals), the residents after the epoch the known
    count ``expect``. Peak memory is read above what was resident before
    the service. Returns the lane rows of its kernels (as ``lane_rows``)
    and its answers, states and counters (``served_outputs``), which path
    h is held to."""
    from repro_torch.core.surveys import (DegreeTriples, LocalVertexCount,
                                          TriangleCount)
    from repro_torch.serve import SurveyService

    served = full["served"] = dict(push_cap=65536, hub_wedge_cap=1 << 20)
    g_base, held, reqs = served_requests(g)
    walls = served["walls"] = {}
    caps = capture_lanes(PATH_KERNELS["served"])

    def timed(name, fn):
        sync(torch, dev)
        t0 = time.perf_counter()
        out = fn()
        sync(torch, dev)
        walls[name] = time.perf_counter() - t0
        return out

    def served_path():
        resident = memory_reset(torch, dev)
        svc = timed("service", lambda: SurveyService(
            g_base, S, device=dev, **SERVED, resident={
                "tc": TriangleCount(), "dt": DegreeTriples(capacity=4096)}))
        try:
            cold = timed("cold", lambda: svc.query_coalesced(reqs))
            before = read_launches()
            warm = timed("warm", lambda: svc.query_coalesced(reqs))
            memo = {k: v - before[k] for k, v in read_launches().items()}
            plans = [svc.cache.peek(k) for k in svc.cache.keys()]
            for i, e in enumerate(plans):
                audit_plan(full, f"f service plan {i} ({e.key[:12]})",
                           e.cfg, e.report)
            base_answers = svc.resident_answers()
            timed("ingest", lambda: svc.append_edges(
                g.src[held], g.dst[held], emeta_i=g.emeta_i[held],
                emeta_f=g.emeta_f[held], wait=True))
            answers = timed("resident", svc.resident_answers)
            ist = svc.ingest_stats()
            outputs = served_outputs(svc, cold, warm, base_answers, answers)
        finally:
            svc.close()
        served.update(
            resident=resident, peak_above=peak_memory(torch, dev) - resident,
            memo_launches=memo, ingest=ist, capture_s=copies(caps),
            plans=[dict(hub_theta=e.cfg.hub_theta, n_hubs=e.report.n_hubs,
                        n_push_steps=e.cfg.n_push_steps,
                        n_hub_steps=e.cfg.n_hub_steps, e_cap=e.gr.e_cap,
                        nbytes=e.nbytes, stats=e.raw[1]) for e in plans])
        return cold, warm, base_answers, answers, outputs

    (cold, warm, base_answers, answers, outputs), launches["served"] = \
        run_path(torch, dev, "served", served_path)
    rows = lane_rows("served", caps, launches, dev)
    for t in ("t1", "t2"):
        require(same(warm[t][0], cold[t][0]), f"served {t}: warm != cold")
        for which, (_, st) in (("cold", cold[t]), ("warm", warm[t])):
            require(st["exact"], f"served {t} {which}: inexact")
        require(cold[t][1]["plan_cache_hit"] == 0.0
                and warm[t][1]["plan_cache_hit"] == 1.0
                and warm[t][1]["served_from"] == "memo",
                f"served {t}: the repeat was not a memo hit")
    require(not any(served["memo_launches"].values()),
            f"the memo hit launched {served['memo_launches']}")
    for e in served["plans"]:
        lost = e["stats"]["pull_overflow"] + e["stats"]["stream_dropped"]
        require(lost == 0.0, f"a served warm-up dropped {lost} lanes")
    t1 = cold["t1"][0]
    require(t1 == base_answers["tc"] < expect,
            f"served t1 {t1} != the residents' base count "
            f"{base_answers['tc']}, or not below {expect}")
    lvc = int(cold["t2"][0].astype(np.int64).sum())
    require(lvc == 3 * t1, f"served t2 sums to {lvc}, not 3 * {t1}")
    dt_base = counting_total(base_answers["dt"])
    require(dt_base == t1, f"resident base DegreeTriples total {dt_base} != {t1}")
    require(answers["tc"] == expect,
            f"resident TriangleCount {answers['tc']} != {expect}")
    dt = counting_total(answers["dt"])
    require(dt == expect, f"resident DegreeTriples total {dt} != {expect}")
    ist = served["ingest"]
    require((ist["epochs_applied"], ist["jit_cache_recompiles"],
             ist["jit_cache_hits"]) == (1, 3, 0),
            f"served epochs / recompiles / hits {ist['epochs_applied']} / "
            f"{ist['jit_cache_recompiles']} / {ist['jit_cache_hits']}, "
            "not 1 / 3 / 0")
    served.update(t1=t1, t2_sum=lvc, resident_triangles=answers["tc"])
    log(f"served stream: walls {json.dumps(walls)}; t1 {t1}, resident "
        f"{answers['tc']} triangles; peak "
        f"{served['peak_above'] / 2**30:.2f} GiB above "
        f"{served['resident'] / 2**30:.2f} GiB resident; launches "
        f"{launches['served']}; plans {served['plans']}")
    return rows, outputs


# path f's service, which path h runs again over a rank pool
SERVED = dict(mode="push", push_cap=65536, hub_theta="auto",
              hub_wedge_cap=1 << 20, cap_policy="bucket")


def served_requests(g):
    """Paths f's and h's base graph (``g`` less ``held_out``), the held-out
    edges and the two tenants."""
    from repro_torch.core.surveys import LocalVertexCount, TriangleCount
    from repro_torch.graphs.csr import HostGraph
    from repro_torch.serve import TenantRequest

    held, keep = held_out(g.m)
    g_base = HostGraph(g.n, g.src[keep], g.dst[keep], g.spec, g.vmeta_i,
                       g.vmeta_f, g.emeta_i[keep], g.emeta_f[keep])
    return g_base, held, [TenantRequest("t1", TriangleCount()),
                          TenantRequest("t2", LocalVertexCount(n=g.n))]


SERVED_COUNTERS = ("plan_cache_hits", "plan_cache_misses",
                   "plan_cache_evictions", "plan_cache_entries",
                   "plan_cache_bytes", "jit_cache_hits",
                   "jit_cache_recompiles", "jit_cache_entries")


def served_outputs(svc, cold, warm, base_answers, answers) -> dict:
    """What paths f and h must agree on: the answers (results bit for
    bit; stats apart, within their float32 rounding), the residents'
    state, each cache entry's memoized state, the cache counters and the
    ingest counters (timings aside)."""
    from repro_torch.interop import state_to_numpy

    entries = [svc.cache.peek(k) for k in svc.cache.keys()]
    ist = svc.ingest_stats()
    return dict(
        results=[{t: out[t][0] for t in out} for out in (cold, warm)],
        stats=[{t: served_answer(*out[t])[1] for t in out}
               for out in (cold, warm)],
        residents=(base_answers, answers),
        state=state_to_numpy(svc.snapshot.resident_state),
        memo=[(e.key, state_to_numpy(e.raw[0])) for e in entries],
        memo_stats=[e.raw[1] for e in entries],
        counters=[{k: out[t][1][k] for t in out for k in SERVED_COUNTERS}
                  for out in (cold, warm)],
        ingest={k: v for k, v in ist.items() if not k.startswith("apply_s")},
        steps=[(e.cfg.n_push_steps, e.cfg.n_hub_steps, e.cfg.n_pull_steps)
               for e in entries])


def stats_near(a: dict, b: dict, adds: int) -> bool:
    """Two runs' stats equal where exact (flags, counters) and within
    float32 rounding where summed: each within ``adds`` half-ulps of the
    other (ROADMAP Queue 3 (k): the mesh sums per rank, then in rank
    order)."""
    if a.keys() != b.keys():
        return False
    for k, v in a.items():
        w = b[k]
        if isinstance(v, float) and isinstance(w, float) and v != w:
            if not f32_near(v, round(w), 2 * adds):
                return False
        elif v != w:
            return False
    return True


def path_served_mesh(torch, dev, full, g, S, f_out, launches):
    """Path h, the served mesh: path f's service (``SERVED``, on path f's
    graph ``g`` less ``held_out``) with ``mesh=`` a ``RankPool`` of S ranks
    sharing the card over gloo, through path f's requests: the service
    built (the residents' warm-up traversal), a cold coalesced
    TriangleCount + LocalVertexCount, the same again (a memo hit: the
    pool gets no job and no rank launches), one ingested epoch of the
    held-out edges, the residents' answers before and after. Every
    answer, state and counter equals path f's (``f_out``) bit for bit,
    the stats within float32 rounding; each plan is audited; each
    traversal's collective bytes reconcile with its plan per lane; the
    ranks hold exactly the cache's entries at the end. Over nccl too
    where there is a card per rank. The walls per request, the pool's
    ready seconds, the slowest rank's collective and staging seconds per
    traversal, the largest rank's peak and the launches over the ranks
    (the parent's: the residents' ``merge_epochs``)."""
    from repro_torch.core.surveys import DegreeTriples, TriangleCount
    from repro_torch.launch.mesh import RankPool
    from repro_torch.serve import SurveyService

    h = full["served_mesh"] = dict(S=S, config=SERVED)
    g_base, held, reqs = served_requests(g)

    def run(backend):
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        reset_launches()
        walls, marks = {}, {}
        t_start = time.perf_counter()
        with RankPool(S, backend=backend,
                      device=None if dev.type == "cuda" else "cpu",
                      timeout=900,
                      workdir=mesh_workdir("served") / backend) as pool:
            ready_s = max(r["ready_s"] for r in pool.ready())
            pool.log = []

            def timed(name, fn):
                n0, t0 = len(pool.log), time.perf_counter()
                out = fn()
                walls[name] = time.perf_counter() - t0
                marks[name] = (n0, len(pool.log))
                return out

            svc = timed("service", lambda: SurveyService(
                g_base, S, device=dev, mesh=pool, **SERVED, resident={
                    "tc": TriangleCount(), "dt": DegreeTriples(capacity=4096)}))
            try:
                cold = timed("cold", lambda: svc.query_coalesced(reqs))
                jobs0, before = pool.jobs_sent, read_launches()
                warm = timed("warm", lambda: svc.query_coalesced(reqs))
                memo = dict(jobs=pool.jobs_sent - jobs0,
                            parent_launches={k: v - before[k] for k, v in
                                             read_launches().items()})
                entries = [svc.cache.peek(k) for k in svc.cache.keys()]
                for i, e in enumerate(entries):
                    audit_plan(full, f"h {backend} service plan {i} "
                               f"({e.key[:12]})", e.cfg, e.report)
                base_answers = svc.resident_answers()
                timed("ingest", lambda: svc.append_edges(
                    g.src[held], g.dst[held], emeta_i=g.emeta_i[held],
                    emeta_f=g.emeta_f[held], wait=True))
                answers = timed("resident", svc.resident_answers)
                out = served_outputs(svc, cold, warm, base_answers, answers)
                on_ranks = [k for ns, k in pool.keys() if ns == svc.mesh_ns]
                require(on_ranks == sorted(svc.cache.keys()),
                        f"path h {backend}: the ranks hold {on_ranks}, the "
                        f"cache {sorted(svc.cache.keys())}")
            finally:
                svc.close()
            log_ = pool.log
        wall = time.perf_counter() - t_start
        parent = read_launches()   # the residents' merge_epochs, on the card
        require(memo["jobs"] == 0 and not any(memo["parent_launches"].values()),
                f"path h {backend}: the memo hit sent {memo['jobs']} job(s) "
                f"to the pool and launched {memo['parent_launches']}")
        # what every traversal did on the ranks, by request
        reports = {e.key: e.report for e in entries}
        runs = []
        for name, (a, b) in marks.items():
            for job, recs in log_[a:b]:
                if job["kind"] != "run":
                    continue
                key, cfg = job["key"][1], job["cfg"]
                tag = f"path h {backend} {name} traversal {len(runs)}"
                runs.append(dict(
                    request=name, cache_key=key, delta=cfg.delta,
                    wall_s=max(r["wall_s"] for r in recs),
                    wire_s_max=max(r["wire_s"] for r in recs),
                    stage_s_max=max(r["stage_s"] for r in recs),
                    peak=max(r["peak"] for r in recs),
                    resident=max(r["resident"] for r in recs),
                    bytes_reconciled=check_mesh_bytes(
                        tag, recs, cfg, reports.get(key), S)))
        require([r["request"] for r in runs] == ["service", "cold", "ingest"],
                f"path h {backend}: traversals {runs}, not one each for the "
                "build, the cold query and the epoch")
        total = {k: sum(r["launches"][k] for _, recs in log_ for r in recs)
                 for k in read_launches()}
        for k in PATH_KERNELS["served_mesh"]:
            require(total[k] > 0 or dev.type != "cuda",
                    f"{k} never launched on path h ({backend})")
        return out, dict(wall_s=wall, ready_s=ready_s, walls=walls,
                         memo=memo, traversals=runs, launches=total,
                         parent_launches=parent,
                         peak=max(r["peak"] for r in runs),
                         jobs=[job["kind"] for job, _ in log_])

    def check(backend, out):
        tag = f"path h {backend}"
        for i, which in enumerate(("cold", "warm")):
            require(same(out["results"][i], f_out["results"][i]),
                    f"{tag} {which}: answers != path f's")
            require(out["counters"][i] == f_out["counters"][i],
                    f"{tag} {which}: cache counters {out['counters'][i]} != "
                    f"path f's {f_out['counters'][i]}")
        adds = [S * (sum(st) + 1) for st in f_out["steps"]]
        for i, which in enumerate(("cold", "warm")):
            for t, st in out["stats"][i].items():
                require(stats_near(st, f_out["stats"][i][t], max(adds)),
                        f"{tag} {which} {t}: stats {st} not within float32 "
                        f"rounding of path f's {f_out['stats'][i][t]}")
        require(same(out["residents"], f_out["residents"]),
                f"{tag}: resident answers != path f's")
        require(same(out["state"], f_out["state"]),
                f"{tag}: resident state != path f's")
        require(same(out["memo"], f_out["memo"]),
                f"{tag}: memoized states != path f's")
        for st, want, a in zip(out["memo_stats"], f_out["memo_stats"], adds):
            require(stats_near(st, want, a),
                    f"{tag}: memoized stats {st} != path f's {want}")
        require(out["ingest"] == f_out["ingest"],
                f"{tag}: ingest counters {out['ingest']} != path f's "
                f"{f_out['ingest']}")

    def show(backend, r):
        log(f"path h {backend}: {S} ranks ready {r['ready_s']:.1f} s after "
            f"the start, whole path {r['wall_s']:.1f} s; walls "
            f"{json.dumps(r['walls'])}; memo hit: {r['memo']['jobs']} jobs; "
            f"largest rank's peak {r['peak'] / 2**30:.2f} GiB; launches over "
            f"the ranks {r['launches']}, in the parent (merging the epoch) "
            f"{r['parent_launches']}")
        for t in r["traversals"]:
            log(f"path h {backend} {t['request']} traversal: "
                f"{t['wall_s']:.2f} s (the slowest rank), collectives "
                f"{t['wire_s_max']:.2f} s, staging {t['stage_s_max']:.2f} s "
                f"(the slowest rank's), peak {t['peak'] / 2**30:.2f} GiB "
                f"({t['resident'] / 2**30:.2f} resident)")

    out, h["gloo"] = run("gloo")
    check("gloo", out)
    show("gloo", h["gloo"])
    launches["served_mesh"] = h["gloo"]["launches"]
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if cards >= S:
        out, h["nccl"] = run("nccl")
        check("nccl", out)
        show("nccl", h["nccl"])
    else:
        h["nccl"] = f"not run: {cards} card(s) seen, {S} ranks need {S}"
        log(f"path h: NCCL not run: {cards} card(s) seen; nccl needs one "
            f"card per rank ({S})")
    log(f"path h: == path f bit for bit (answers, residents, states, "
        f"counters; stats within float32 rounding), plans audited, bytes "
        f"reconciled per traversal")


def path_mesh(torch, dev, full, g, gr, expect, plans, reports, results,
              launches):
    """Full-size path g, the mesh transport: path a's graph ``g`` and its
    stacked shards ``gr`` (saved once, one file per rank, each rank
    loading its slice), S=8 rank processes sharing the card over gloo
    (every collective staged through host memory). TriangleCount
    push-pull on a ``transport="mesh"`` plan (ragged caps, scheduled
    rounds) equals path a's count, the known ``expect``; DegreeTriples
    push-pull on path a's dense plan relabelled mesh (uniform caps:
    all_to_all_single) equals path a's bit for bit. The stats within
    their float32 rounding of the plan; the bytes handed to the
    collectives reconcile with the plan (``check_mesh_bytes``); both
    plans audited (``audit_plan``). Over nccl too where there is a card
    per rank. Returns rows of rank 0's largest wedge_check and
    wedge_intersect launches (as ``lane_rows``)."""
    from repro_torch.core.pushpull import plan_engine
    from repro_torch.launch.mesh import RankRun, save_slices

    S = MESH_FULL_S
    require(gr.S == S, f"path g needs path a's {S} shards")
    mesh = full["mesh"] = dict(S=S, backend="gloo")
    survey_tc, _, _ = plans[("TriangleCount", "pushpull")]
    survey_dt, cfg_dt, _ = plans[("DegreeTriples", "pushpull")]
    t0 = time.perf_counter()
    cfg_tc, rep_tc = plan_engine(g, S, survey_tc, mode="pushpull",
                                 push_cap=4096, pull_q_cap=16,
                                 transport="mesh")
    mesh["plan_s"] = time.perf_counter() - t0
    cfg_dt = dataclasses.replace(cfg_dt, transport="mesh")
    rep_dt = reports[("DegreeTriples", "pushpull")]
    audit_plan(full, "g TriangleCount pushpull mesh", cfg_tc, rep_tc)
    audit_plan(full, "g DegreeTriples pushpull dense relabelled mesh",
               cfg_dt, rep_dt)
    wd = mesh_workdir("full")
    t0 = time.perf_counter()
    save_slices(gr, wd / "slices")
    mesh["save_s"] = time.perf_counter() - t0
    src = str(wd / "slices" / "slice{rank}.pt")
    jobs = [dict(kind="survey", gr=src, survey=survey_tc, cfg=cfg_tc,
                 entry="pushpull", capture=("wedge_check", "wedge_intersect")),
            dict(kind="survey", gr=src, survey=survey_dt, cfg=cfg_dt,
                 entry="pushpull")]
    mesh["schedule"] = dict(
        push=(rep_tc.sched_push_rounds, rep_tc.sched_push_slots,
              rep_tc.naive_push_rounds, rep_tc.naive_push_slots),
        req=(rep_tc.sched_req_rounds, rep_tc.sched_req_slots,
             rep_tc.naive_req_rounds, rep_tc.naive_req_slots))
    log(f"plan mesh TriangleCount pushpull: {mesh['plan_s']:.1f} s, push "
        f"steps {cfg_tc.n_push_steps}, pull steps {cfg_tc.n_pull_steps}; "
        f"scheduled (rounds, slots) vs rotation: {mesh['schedule']}; slices "
        f"saved in {mesh['save_s']:.1f} s")

    def run(backend):
        if dev.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        reset_launches()
        t0 = time.perf_counter()
        ranks = RankRun(S, jobs, wd / backend, backend=backend,
                        device=None if dev.type == "cuda" else "cpu",
                        timeout=900).start().wait()
        wall = time.perf_counter() - t0
        require(not any(read_launches().values()),
                "the parent launched a kernel during path g")
        summary = mesh_summary(ranks, {"TriangleCount": 0, "DegreeTriples": 1})
        for i, name in enumerate(("TriangleCount", "DegreeTriples")):
            want = results[(name, "pushpull")][0]
            outs = [r["outputs"][i] for r in ranks]
            for r, o in enumerate(outs):
                tag = f"path g {backend} {name} rank {r}"
                require(same(o["result"], want), f"{tag}: != path a's")
                require(o["stats"]["exact"], f"{tag}: inexact")
            cfg, rep = ((cfg_tc, rep_tc), (cfg_dt, rep_dt))[i]
            summary[name]["bytes_reconciled"] = check_mesh_bytes(
                f"path g {backend} {name}", outs, cfg, rep, S)
            st = outs[0]["stats"]
            adds_push = cfg.n_push_steps * S + S
            adds_pull = cfg.n_pull_steps * S + S
            require(f32_near(st["wedges_pushed"], rep.pushpull_push_entries,
                             adds_push), f"path g {name}: pushed wedges != plan")
            require(f32_near(st["pull_requests"], rep.pushpull_requests,
                             adds_pull), f"path g {name}: pull requests != plan")
            require(f32_near(st["tris_push"] + st["tris_pull"], expect,
                             adds_push + adds_pull),
                    f"path g {name}: tris_push + tris_pull != {expect}")
            for k, vol in (("wire_push_words", rep.wire_push_bytes),
                           ("wire_req_words", rep.wire_req_bytes),
                           ("wire_reply_words", rep.wire_reply_bytes)):
                require(f32_near(st[k], vol // 4, max(cfg.n_push_steps,
                                                      cfg.n_pull_steps)),
                        f"path g {name}: {k} {st[k]} != plan {vol // 4}")
            summary[name]["stats"] = st
        total = {k: sum(s["launches"][k] for s in summary.values())
                 for k in summary["TriangleCount"]["launches"]}
        for k in PATH_KERNELS["mesh"]:
            require(total[k] > 0 or dev.type != "cuda",
                    f"{k} never launched on path g ({backend})")
        out = dict(wall_s=wall, ready_s=max(r["ready_s"] for r in ranks),
                   jobs=summary, launches=total)
        for name, s in summary.items():
            log(f"path g {backend} {name} pushpull: {s['wall_s']:.2f} s (the "
                f"slowest rank), peak {s['peak'] / 2**30:.2f} GiB (the largest "
                f"rank's, {s['resident'] / 2**30:.2f} resident); collectives "
                f"{s['wire_s_max']:.2f} s, staging {s['stage_s_max']:.2f} s "
                f"(the slowest rank; summed {s['wire_s_sum']:.2f} / "
                f"{s['stage_s_sum']:.2f}); bytes {s['bytes']} reconciled; "
                f"launches {s['launches']}")
        log(f"path g {backend}: {S} ranks ready {out['ready_s']:.1f} s after "
            f"the spawn, whole path {wall:.1f} s; launches over the ranks "
            f"{total}")
        return ranks, out

    ranks, mesh["gloo"] = run("gloo")
    launches["mesh"] = mesh["gloo"]["launches"]
    cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    if cards >= S:
        _, mesh["nccl"] = run("nccl")
    else:
        mesh["nccl"] = f"not run: {cards} card(s) seen, {S} ranks need {S}"
        log(f"path g: NCCL not run: {cards} card(s) seen; nccl needs one "
            f"card per rank ({S})")
    rows = []
    for name, entry in ranks[0]["outputs"][0]["captured"].items():
        require(entry is not None or dev.type != "cuda",
                f"path g: rank 0 captured no {name} launch")
        if entry is not None:
            rows.append(dict(key=f"{name}_g_rank0", name=name, path="mesh",
                             lane="rank0", launches=launches["mesh"][name],
                             entry=entry))
    return rows


# ---------------------------------------------------------------------------
# the examples phase and path i: the paper's downstream loop

DOWNSTREAM_STEPS = 60     # training steps of each run on path i (the example's)


def phase_examples(torch, report, dev):
    """Each of the port's examples (``repro_torch.examples``) at its own
    size on the card, its printed lines and numbers held to its JAX twin's
    recorded lines (``repro_torch.examples.expected.check``: the survey
    examples line for line; the GNN example's survey line, its first
    training steps' losses within ``LOSS_TOL``, falling losses and a
    positive gain)."""
    import contextlib
    import io

    from repro_torch.examples import NAMES, expected

    out = report["examples"] = {}
    for name in NAMES:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        buf = io.StringIO()
        sync(torch, dev)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            numbers = mod.main(device=dev)
        sync(torch, dev)
        wall = time.perf_counter() - t0
        errs = expected.check(name, buf.getvalue(), numbers)
        require(not errs, f"example {name} differs from its twin: {errs}")
        row = out[name] = dict(wall_s=wall,
                               lines=len(buf.getvalue().splitlines()))
        if name == expected.GNN:
            row["drift"] = expected.gnn_drift(numbers)
            row["step_gaps"] = [
                [a - b for a, b in zip(numbers[r]["losses"], trace)]
                for r, trace in zip(("base", "tri"), expected.GNN_STEP_LOSSES)]
            row["first_steps_gap"] = [max(abs(x) for x in gaps[
                :expected.TRACE_STEPS]) for gaps in row["step_gaps"]]
            row["first_step_past_tol"] = expected.first_steps_past(numbers)
        log(f"example {name}: {wall:.2f} s, {row['lines']} lines == the "
            "twin's" + (f"; first {expected.TRACE_STEPS} step losses within "
                        f"{row['first_steps_gap']} of the twin's, the gap "
                        f"first past {expected.LOSS_TOL} at steps "
                        f"{row['first_step_past_tol']}, finals "
                        f"{json.dumps(row['drift'])}" if "drift" in row else ""))


# path i's first training step held to float64 (downstream_witness)
WITNESS_H = 1e-6           # central-difference step along a unit direction
WITNESS_LOSS_RTOL = 1e-4   # float32 losses vs the float64 loss
WITNESS_GRAD_RTOL = 1e-3   # directional derivatives, relative to |g|
WITNESS_PARAM_ATOL = 1e-6  # AdamW's step vs its float64 restatement


def downstream_witness(torch, dev, g, counts, cfg, first_loss) -> dict:
    """Path i's first training step with the triangle feature (CONFIG
    widths, full batch, the run's initial weights) against float64 on the
    card, with the same weights and batch:
    - loss: the trainer's float32 loss, and the first loss the run logged,
      within ``WITNESS_LOSS_RTOL`` of the float64 loss;
    - gradient: autograd's float32 gradient g (as the trainer hands it to
      AdamW) against float64 central differences of the loss, a check
      that does not go through autograd, along g/|g| and along a seeded
      random unit direction, each within ``WITNESS_GRAD_RTOL`` × |g|;
      along g/|g| the derivative is the trainer's ``grad_norm``;
    - AdamW: the trainer's new weights within ``WITNESS_PARAM_ATOL`` of
      AdamW restated here in float64 from g (global-norm clip at 1, b1
      0.9, b2 0.999, eps 1e-8, both bias corrections, lr 5e-3)."""
    from repro_torch.examples import triangle_features_gnn as tfg
    from repro_torch.train import adamw, make_train_step
    from repro_torch.train.optimizer import tree_leaves, tree_unflatten
    from repro_torch.train.trainer import init_state

    t0 = time.perf_counter()
    _, feats, labels = tfg.features(g, np.asarray(counts, np.float32))
    mc = tfg.model_cfg(cfg, feats.shape[1])
    loss_fn = tfg.make_loss(mc, torch.as_tensor(labels, device=dev))
    batch = tfg.make_graph(g, feats, dev)
    p0 = tfg.init_weights(mc, dev)
    seen = []

    def capture(grads, ef):
        seen.append(grads)
        return grads, ef

    opt = adamw(5e-3)
    state, m = make_train_step(loss_fn, opt, grad_transform=capture)(
        init_state(p0, opt), batch)
    grads = [x.double() for x in tree_leaves(seen[0])]
    step_loss, step_gn = float(m["loss"]), float(m["grad_norm"])
    gn = float(torch.sqrt(sum((x * x).sum() for x in grads)))

    w64 = [x.double() for x in tree_leaves(p0)]
    b64 = dataclasses.replace(batch, node_feat=batch.node_feat.double(),
                              positions=batch.positions.double())

    @torch.no_grad()
    def loss64(direction=None, h=0.0):
        ws = w64 if direction is None else [
            w + h * u for w, u in zip(w64, direction)]
        return float(loss_fn(tree_unflatten(p0, ws), b64)[0])

    gen = torch.Generator().manual_seed(0)
    rand = [torch.randn(w.shape, generator=gen, dtype=torch.float64).to(dev)
            for w in w64]
    rn = float(torch.sqrt(sum((x * x).sum() for x in rand)))
    dirs = dict(gradient=[x / gn for x in grads], random=[x / rn for x in rand])
    ref = loss64()
    derivs = {}
    for name, u in dirs.items():
        fd = (loss64(u, WITNESS_H) - loss64(u, -WITNESS_H)) / (2 * WITNESS_H)
        ad = float(sum((x * y).sum() for x, y in zip(grads, u)))
        derivs[name] = dict(autograd=ad, float64_difference=fd,
                            rel_err=abs(fd - ad) / gn)

    clip = min(1.0, 1.0 / max(gn, 1e-9))
    worst = 0.0
    for w, x, new in zip(w64, grads, tree_leaves(state.params)):
        x = x * clip
        mom, var = 0.1 * x, 0.001 * x * x
        upd = (mom / 0.1) / (torch.sqrt(var / 0.001) + 1e-8)
        worst = max(worst, float((new.double() - (w - 5e-3 * upd)).abs().max()))
    out = dict(loss_float64=ref, step_loss=step_loss, first_loss=first_loss,
               loss_rel_err=max(abs(step_loss - ref), abs(first_loss - ref))
               / abs(ref),
               grad_norm=step_gn, grad_norm_recomputed=gn, derivatives=derivs,
               adamw_max_abs_err=worst, h=WITNESS_H, wall_s=None)
    require(out["loss_rel_err"] <= WITNESS_LOSS_RTOL,
            f"path i witness: float32 losses {step_loss}, {first_loss} vs "
            f"float64 {ref}: {out['loss_rel_err']} > {WITNESS_LOSS_RTOL}")
    require(abs(step_gn - gn) <= WITNESS_LOSS_RTOL * gn,
            f"path i witness: grad_norm {step_gn} vs |g| {gn}")
    for name, d in derivs.items():
        require(d["rel_err"] <= WITNESS_GRAD_RTOL,
                f"path i witness: derivative along the {name} direction: "
                f"autograd {d['autograd']} vs float64 central difference "
                f"{d['float64_difference']} (|g| {gn}) > {WITNESS_GRAD_RTOL}")
    require(worst <= WITNESS_PARAM_ATOL,
            f"path i witness: AdamW's step {worst} from its float64 "
            f"restatement > {WITNESS_PARAM_ATOL}")
    sync(torch, dev)
    out["wall_s"] = time.perf_counter() - t0
    return out


def path_downstream(torch, dev, full, g, gr, S, lvc_bundle, launches):
    """Path i, the paper's downstream loop at full width: the GNN
    example's ``run`` on path a's graph and shards — a push-pull
    LocalVertexCount survey (path a's plan parameters) whose counts equal
    path b's bundle member bit for bit, then SchNet at
    ``configs/schnet.py``'s published widths (3 interactions, 64 wide, 300
    Gaussian bases, cutoff 10; node features 2 and 3, two classes) trained
    full batch over every directed edge by the port's AdamW, once on
    degree features and once with the triangle feature. Losses finite and
    falling (``expected.losses_fall``: the median of the last ten below
    the first), and the first step with the triangle feature held to
    float64 (``downstream_witness``); the survey's wall, each step's wall
    and the peak."""
    from repro_torch.configs import schnet as schnet_config
    from repro_torch.examples import expected
    from repro_torch.examples import triangle_features_gnn as tfg

    base = memory_reset(torch, dev)
    t0 = time.perf_counter()
    out, launches["downstream"] = run_path(
        torch, dev, "downstream",
        lambda: tfg.run(g, S=S, cfg=schnet_config.CONFIG, gr=gr, device=dev,
                        steps=DOWNSTREAM_STEPS, push_cap=4096, pull_q_cap=16))
    wall = time.perf_counter() - t0
    peak = peak_memory(torch, dev)
    require(np.array_equal(np.asarray(out["counts"]), np.asarray(lvc_bundle)),
            "path i's LocalVertexCount != path b's bundle member")
    require(out["survey_stats"]["exact"], "path i's survey inexact")
    runs = {}
    for r in ("base", "tri"):
        x = out[r]
        require(all(np.isfinite(x["losses"])), f"path i {r}: a loss not finite")
        require(expected.losses_fall(x["losses"]),
                f"path i {r}: the last {expected.FALL_STEPS} step losses "
                f"{x['losses'][-expected.FALL_STEPS:]} did not fall below "
                f"the first step's {x['losses'][0]}")
        steps = x["step_s"]
        runs[r] = dict(first_loss=x["losses"][0], loss=x["loss"],
                       last_median_loss=statistics.median(
                           x["losses"][-expected.FALL_STEPS:]),
                       losses=x["losses"],
                       accuracy=x["accuracy"], first_step_s=steps[0],
                       median_step_s=statistics.median(steps[1:] or steps),
                       train_s=sum(steps))
    memory_reset(torch, dev)
    witness = downstream_witness(torch, dev, g, out["counts"],
                                 schnet_config.CONFIG, out["tri"]["losses"][0])
    witness["max_memory_allocated"] = peak_memory(torch, dev)
    full["downstream"] = dict(
        edges_directed=2 * g.m, vertices=g.n, steps=DOWNSTREAM_STEPS,
        survey_s=out["survey_s"], wall_s=wall, resident_bytes=base,
        max_memory_allocated=peak, runs=runs, gain=out["gain"],
        witness=witness,
        counts_sum=int(np.asarray(out["counts"]).astype(np.int64).sum()))
    log(f"path i: LocalVertexCount push-pull {out['survey_s']:.2f} s == path "
        f"b's bit for bit; SchNet 3x64, 300 bases over {2 * g.m} edges, "
        f"{DOWNSTREAM_STEPS} steps a run: " + "; ".join(
            f"{r} loss {v['first_loss']:.4f} -> {v['loss']:.4f} (median of "
            f"the last {expected.FALL_STEPS} {v['last_median_loss']:.4f}), accuracy "
            f"{v['accuracy']:.3f}, first step {v['first_step_s']:.3f} s, "
            f"median {v['median_step_s']:.4f} s, {v['train_s']:.2f} s"
            for r, v in runs.items())
        + f"; gain {out['gain']:+.1f} points; path {wall:.2f} s; peak "
        f"{peak / 2**30:.2f} GiB ({base / 2**30:.2f} resident before); "
        f"launches {launches['downstream']}")
    log("path i witness (first step with the triangle feature vs float64): "
        f"loss {witness['loss_float64']:.6f}, float32 off by "
        f"{witness['loss_rel_err']:.2e} (rtol {WITNESS_LOSS_RTOL}); grad_norm "
        f"{witness['grad_norm']:.6g}; derivatives autograd vs float64 central "
        "difference " + ", ".join(
            f"{k} {d['autograd']:.6g} vs {d['float64_difference']:.6g} "
            f"({d['rel_err']:.2e} of |g|)"
            for k, d in witness["derivatives"].items())
        + f" (rtol {WITNESS_GRAD_RTOL}); AdamW vs float64 "
        f"{witness['adamw_max_abs_err']:.2e} (atol {WITNESS_PARAM_ATOL}); "
        f"{witness['wall_s']:.2f} s, peak "
        f"{witness['max_memory_allocated'] / 2**30:.2f} GiB")


# ---------------------------------------------------------------------------
# path j: the rest of the GNN zoo at its published widths

ZOO = (("dimenet", "DimeNet"), ("nequip", "NequIP"),
       ("equiformer-v2", "EquiformerV2"))
ZOO_SHAPE = "molecule"     # the JAX package's GNN_CELL_DIMS cell
ZOO_BOX = 100.0            # box edge: 7,308 of the 8,192 edge slots real
ZOO_STEPS = 10             # AdamW steps a model
ZOO_CHUNKS = 8             # EquiformerV2's streaming attention, held to 1
# graph energies: float32 vs float64, rotated vs not, 8 chunks vs 1; the
# worst difference relative to the largest |energy| of the float64 run
ZOO_RTOL = 1e-4


def rotation(seed: int) -> np.ndarray:
    """A seeded rotation, Rz(a) Ry(b) Rz(c)."""
    a, b, c = np.random.default_rng(seed).uniform(0, 2 * np.pi, 3)
    rz = lambda t: np.array([[np.cos(t), -np.sin(t), 0],
                             [np.sin(t), np.cos(t), 0], [0, 0, 1]])
    ry = lambda t: np.array([[np.cos(t), 0, np.sin(t)], [0, 1, 0],
                             [-np.sin(t), 0, np.cos(t)]])
    return rz(a) @ ry(b) @ rz(c)


def zoo_batch(torch, dev, n_nodes, e_cap, n_graphs, t_cap, box):
    """The molecule cell's batch: ``radius_graph_batch`` (seeded) and
    DimeNet's triplets of its real edges (``build_triplets`` with the
    cell's cap: more triplets than that raise, as in the reference), the
    seeded graph energies."""
    from repro_torch.models.gnn.common import build_triplets, radius_graph_batch

    g = radius_graph_batch(torch.Generator().manual_seed(0), n_nodes,
                           cutoff=5.0, box=box, e_cap=e_cap,
                           n_graphs=n_graphs, device=dev)
    n_real = int(g.edge_valid.sum())
    require(0.75 * e_cap <= n_real <= e_cap,
            f"path j: {n_real} real edges of {e_cap} slots, not 75-100%")
    src, dst = (x[:n_real].cpu().numpy() for x in (g.edge_src, g.edge_dst))
    require(bool(g.edge_valid[:n_real].all()), "path j: padding before edges")
    tri = build_triplets(src, dst, n_nodes, t_cap)
    labels = torch.tensor(np.random.default_rng(2).normal(size=n_graphs),
                          dtype=torch.float32, device=dev)
    return g, n_real, [torch.as_tensor(t, device=dev) for t in tri], labels


def path_zoo(torch, dev, full, widths="CONFIG"):
    """Path j: DimeNet, NequIP and EquiformerV2 at ``configs/<arch>.py``'s
    CONFIG widths on the JAX package's molecule cell (128 graphs, 3,840
    atoms, 8,192 edge slots, graph energies), weights from
    ``threefry.prng_key(1)``:
    - forward in float32 against the same module in float64, and against
      positions under a seeded rotation (within ``ZOO_RTOL``);
    - EquiformerV2 with ``edge_chunks = ZOO_CHUNKS`` against 1;
    - ``ZOO_STEPS`` AdamW(1e-3) steps of the energy loss through
      ``make_train_step``: finite losses, the first and the median step
      wall, the peak, model TFLOP/s (``launch.steps.gnn_flops``);
    - one profiled step a model (the device's idle share).
    ``widths="SMOKE"`` narrows the models for a CPU rehearsal; the batch
    stays the cell's."""
    from repro_torch.launch.steps import gnn_cell
    from repro_torch.models import threefry
    from repro_torch.train import adamw, make_train_step
    from repro_torch.train.optimizer import tree_map
    from repro_torch.train.trainer import init_state

    cells = {arch: gnn_cell(arch, ZOO_SHAPE, widths) for arch, _ in ZOO}
    dims = cells["dimenet"].dims
    n_nodes, box = dims["N_logical"], ZOO_BOX
    t0 = time.perf_counter()
    g, n_real, tri, labels = zoo_batch(
        torch, dev, n_nodes, cells["dimenet"].e_pad, dims["n_graphs"],
        cells["dimenet"].t_cap, box)
    rot = torch.tensor(rotation(3), dtype=torch.float32, device=dev)
    g_rot = dataclasses.replace(g, positions=g.positions @ rot.T)
    g64 = dataclasses.replace(g, positions=g.positions.double())
    out = full["zoo"] = dict(
        shape=ZOO_SHAPE, widths=widths, nodes=n_nodes, graphs=dims["n_graphs"],
        edge_slots=cells["dimenet"].e_pad, edges=n_real,
        triplets=int(tri[2].sum()), t_cap=cells["dimenet"].t_cap, box=box,
        batch_s=time.perf_counter() - t0, rtol=ZOO_RTOL, models={})
    log(f"path j: molecule cell, {n_nodes} atoms in {dims['n_graphs']} "
        f"graphs, box {box}, {n_real} real edges of {out['edge_slots']} slots "
        f"({100 * n_real / out['edge_slots']:.1f}%), DimeNet {out['triplets']} "
        f"triplets (cap {out['t_cap']}); batch {out['batch_s']:.2f} s")

    def rel(a, b, ref):
        return float((a.double() - b.double()).abs().max()
                     / ref.double().abs().max())

    for arch, cls in ZOO:
        cell = cells[arch]
        model = getattr(cell.module, cls)(cell.cfg, key=threefry.prng_key(1),
                                          device=dev)
        p32 = model.tree()
        p64 = tree_map(lambda t: t.detach().double(), p32)
        args = ((tri,) if arch == "dimenet" else ())

        @torch.no_grad()
        def energies(params, graph, cfg=cell.cfg):
            return cell.module.forward(cfg, params, graph, *args)[1][:, 0]

        e32, e64 = energies(p32, g), energies(p64, g64)
        e_rot = energies(p32, g_rot)
        row = out["models"][arch] = dict(
            cfg=dataclasses.asdict(cell.cfg),
            params=sum(p.numel() for p in model.parameters()),
            float64_rel_err=rel(e32, e64, e64),
            rotation_rel_err=rel(e_rot, e32, e64))
        if arch == "equiformer-v2":
            e_ch = energies(p32, g, dataclasses.replace(
                cell.cfg, edge_chunks=ZOO_CHUNKS))
            row["chunks"] = ZOO_CHUNKS
            row["chunked_rel_err"] = rel(e_ch, e32, e64)
        for k in ("float64_rel_err", "rotation_rel_err", "chunked_rel_err"):
            require(k not in row or row[k] <= ZOO_RTOL,
                    f"path j {arch}: {k} {row.get(k)} > {ZOO_RTOL}")
        require(bool(torch.isfinite(e32).all()), f"path j {arch}: energies")

        batch = dict(graph=g, labels=labels)
        if arch == "dimenet":
            batch.update(t_in=tri[0], t_out=tri[1], t_valid=tri[2])
        opt = adamw(1e-3)
        step = make_train_step(cell.loss_fn, opt)
        state = init_state(tree_map(lambda t: t.detach().clone(), p32), opt)
        base = memory_reset(torch, dev)
        losses, walls = [], []
        for _ in range(ZOO_STEPS):
            sync(torch, dev)
            t1 = time.perf_counter()
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
            walls.append(time.perf_counter() - t1)
        peak = peak_memory(torch, dev)
        require(all(np.isfinite(losses)), f"path j {arch}: losses {losses}")
        median = statistics.median(walls[1:])
        row.update(losses=losses, first_step_s=walls[0], median_step_s=median,
                   step_s=walls, resident_bytes=base,
                   max_memory_allocated=peak,
                   model_flops_step=cell.model_flops,
                   tflops=cell.model_flops / median / 1e12)
        if dev.type == "cuda":
            st = [state]

            def one():
                st[0] = step(st[0], batch)[0]

            row["profile"] = profile_run(torch, f"path j {arch} step", one,
                                         top=8)
        log(f"path j {arch}: {row['params']} parameters; energies float32 vs "
            f"float64 {row['float64_rel_err']:.2e}, rotated "
            f"{row['rotation_rel_err']:.2e}"
            + (f", {ZOO_CHUNKS} chunks {row['chunked_rel_err']:.2e}"
               if "chunks" in row else "")
            + f" (rtol {ZOO_RTOL}); losses {losses[0]:.6g} -> "
            f"{losses[-1]:.6g}; first step {walls[0]:.3f} s, median "
            f"{median:.4f} s; peak {peak / 2**30:.2f} GiB ({base / 2**30:.2f} "
            f"resident before); {row['tflops']:.3f} model TFLOP/s "
            f"({cell.model_flops / 1e9:.2f} GFLOP a step)")
        del model, state, p32, p64
    return out


# the port's kernels as the profiler names them (fold_kernel: the fold body
# of fold_count_max, hist_add and hist_max)
PORT_KERNEL_NAMES = ("wedge_check", "wedge_intersect", "fold_kernel",
                     "ring_set", "intersect", "hist_add", "hist_max")


def profile_run(torch, label, fn, top=12) -> dict:
    """Device time by kernel over one run (torch.profiler, CUDA activity
    only): busy time, wall time, idle share, the heaviest kernels, and
    each of the port's kernels wherever it ranks."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        t_read = time.perf_counter()   # the trace's collection and reading
    rows = []
    for ev in prof.key_averages():
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            rows.append((us, ev.count, ev.key))
    rows.sort(reverse=True)
    busy = sum(r[0] for r in rows) / 1e6
    out = dict(label=label, wall_s=wall, device_busy_s=busy,
               read_s=time.perf_counter() - t_read,
               idle_share=(1 - busy / wall) if busy else None,
               top=[dict(kernel=k[:120], ms=us / 1e3, count=c)
                    for us, c, k in rows[:top]],
               port=[dict(kernel=k[:120], ms=us / 1e3, count=c,
                          share=us / 1e6 / busy)
                     for us, c, k in rows
                     if any(n in k for n in PORT_KERNEL_NAMES)])
    log(f"profile {label}: wall {wall:.2f} s, device busy "
        f"{busy:.2f} s, idle share {out['idle_share']}")
    for r in out["top"]:
        log(f"  {r['ms']:10.1f} ms  x{r['count']:<7} {r['kernel']}")
    for r in out["port"]:
        log(f"  port kernel {r['ms']:10.1f} ms  x{r['count']:<7} "
            f"{100 * r['share']:.2f}% of busy  {r['kernel']}")
    return out


# ---------------------------------------------------------------------------
# phase 6: timing at the captured shapes


def time_ms(torch, fn, reps=20, warmup=3) -> float:
    """Median device time of one call, by CUDA events. A spin kernel
    keeps the card busy while the host enqueues every call, so the events
    time the calls back to back on the device and not the host's
    wrapper overhead. Calls slower than 100 ms take 3 repetitions."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    if time.perf_counter() - t0 > 0.1:
        reps = min(reps, 3)
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
    the range check (two) per scatter element and one atomic or store per
    kept word."""
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
    if name == "intersect":
        rd, rh, ri, ln, qd, qh, qi = args
        B, L = qd.shape
        seen, probes = _probed(torch, rd, rh, ri, torch.zeros_like(qi),
                               ln.clamp(0, L)[:, None].expand(B, L).contiguous(),
                               qd, qh, qi, lower_bound_steps(L))
        nbytes = 4 * B + 12 * B * L + 12 * int(seen.sum()) + 4 * B * L
        return nbytes, OPS_PER_PROBE * probes
    if name == "ring_set":
        prior, slots, _, cap = args
        B = slots.shape[0]
        s = slots[(slots >= 0) & (slots < cap)]
        winners = int(torch.unique(s).numel())
        return (4 * B + 12 * winners + 2 * 12 * cap,
                2 * B + int(s.numel()) + 3 * winners)
    slots, cap = args[0], args[-1]
    B = slots.shape[0]
    kept = int(((slots >= 0) & (slots < cap)).sum())
    if name == "hist_add":
        return 4 * B + 4 * kept + 4 * cap, 2 * B + kept
    if name == "hist_max":
        W = args[1].shape[-1]
        return 4 * B + 4 * kept * W + 4 * cap * W, 2 * B + kept * W
    slots, amounts, rows, cap = args              # fold_count_max
    W = rows.shape[-1]
    return (4 * B + 4 * kept * (1 + W) + 4 * cap * (1 + W),
            2 * B + kept * (1 + W))


def library_call(torch, name, args):
    """One PyTorch call (or call pair) computing the kernel's function on
    its operands, prepared outside the timed call (slots remapped past the
    end, rows sign-flipped); None where PyTorch has none."""
    if name in ("wedge_check", "wedge_intersect", "intersect"):
        return None        # no PyTorch call lower-bounds a composite key
    slots = args[1] if name == "ring_set" else args[0]
    cap = args[-1]
    dev = slots.device
    ok = (slots >= 0) & (slots < cap)
    if name == "ring_set":
        # dropped elements offer -1 at slots of their own, so that no one
        # slot serialises every dropped element's atomic
        prior, _, rows, _ = args
        if isinstance(rows, tuple):                # Enumerate's columns
            rows = torch.stack(rows, -1)
        gidx = torch.arange(slots.shape[0], dtype=torch.int64, device=dev)
        s = torch.where(ok, slots.long(), gidx % cap)
        v = torch.where(ok, gidx, -1)

        def run():
            win = torch.full((cap,), -1, dtype=torch.int64, device=dev)
            win.scatter_reduce_(0, s, v, "amax")
            torch.where((win >= 0)[:, None], rows[win.clamp_min(0)], prior)
        return run
    s = torch.where(ok, slots, cap).long()
    if name == "hist_add":
        amounts = args[1]

        def run():
            torch.zeros(cap + 1, dtype=torch.int32, device=dev).index_add_(0, s, amounts)
        return run
    rows_k = args[-2] ^ INT32_MIN
    W = rows_k.shape[-1]
    idx = s[:, None].expand(-1, W)

    def run_max():
        packed = torch.full((cap + 1, W), INT32_MIN, dtype=torch.int32, device=dev)
        packed.scatter_reduce_(0, idx, rows_k, "amax")
    if name == "hist_max":
        return run_max
    amounts = args[1]                              # fold_count_max

    def run():
        torch.zeros(cap + 1, dtype=torch.int32, device=dev).scatter_add_(0, s, amounts)
        run_max()
    return run


def _shape(a):
    if isinstance(a, tuple):
        return [_shape(x) for x in a]
    return list(a.shape) if hasattr(a, "shape") else a


def measure(torch, name, entry) -> dict:
    """Time a kernel, its plain version and its library call on captured
    operands, and compute its bound from them."""
    from repro_torch.roofline import HW

    (args, kw), kern, plain = entry
    ms = time_ms(torch, lambda: kern(*args, **kw))
    plain_ms = time_ms(torch, lambda: plain(*args, **kw), reps=5, warmup=1)
    lib = library_call(torch, name, args)
    lib_ms = time_ms(torch, lib) if lib is not None else None
    hw = HW()     # the bound's rates: device memory, int32 operations
    nbytes, nops = bound_work(torch, name, args, kw)
    bytes_ms = nbytes / hw.hbm_bw * 1e3
    ops_ms = nops / hw.peak_int32_ops * 1e3
    row = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               library_ms=lib_ms, bytes=nbytes, operations=nops,
               bytes_ms=bytes_ms, ops_ms=ops_ms,
               shapes=[_shape(a) for a in args])
    log(f"time {name}: {ms:.4f} ms (plain {plain_ms:.4f} ms, bound "
        f"{row['bound_ms']:.5f} ms by {row['bound_by']}: bytes "
        f"{bytes_ms:.5f} ms, operations {ops_ms:.5f} ms; library {lib_ms}) "
        f"at {row['shapes']}")
    return row


def phase_timing(torch, report, captured, launches, errs):
    rows = []
    commons = {}
    for name, mod, _, source, replaces in KERNELS:
        common = commons[name] = dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches_by_path={PATH_LETTERS[k]: v[name]
                              for k, v in launches.items()})
        launched = launches[REPORTED_PATH[name]][name]
        if name in HIST_CALLERS:
            # where the launches are: each caller's modal (and largest)
            # fold on the bundle path; launches are the caller's
            for call in captured["hist_callers"]:
                if call["name"] != name:
                    continue
                row = dict(common, launches=call["caller_launches"],
                           max_abs_err=call["max_abs_err"],
                           **measure(torch, name, call["entry"]))
                row.update((k, call[k]) for k in (
                    "caller", "fold", "batch", "bin", "launches_in_bin"))
                row["loss_s"] = (row["launches"]
                                 * (row["ms"] - row["bound_ms"]) / 1e3)
                rows.append(row)
            # the shape earlier runs timed, kept for comparison
            shape = "DegreeTriples' largest fold: no real call has this shape"
        else:
            shape = None
        rows.append(dict(common, launches=launched, max_abs_err=errs[name],
                         **measure(torch, name, captured[name])))
        if shape:
            rows[-1].update(caller=None, fold=shape)
    # paths d, e and f: each kernel's lanes at their largest launch, launches
    # the lane's on that path
    for lane in captured["lane_rows"]:
        at = f"path {PATH_LETTERS[lane['path']]}" + {
            "hub": ", hub search", "push": ", push lane",
            "rank0": ", rank 0"}.get(lane["lane"], "")
        rows.append(dict(
            commons[lane["name"]], launches=lane["launches"],
            max_abs_err=errs[lane["key"]], at=f"{at}: its largest launch",
            **measure(torch, lane["name"], captured[lane["key"]])))
    # fold_count_max with rows of 16 words (no real call has that shape;
    # launches are path a's)
    rows.append(dict(commons["fold_count_max"],
                     launches=launches["first"]["fold_count_max"],
                     max_abs_err=errs["fold_count_max_w16"],
                     at="path a's largest fold with rows of 16 words: no real call",
                     **measure(torch, "fold_count_max",
                               captured["fold_count_max_w16"])))
    ranked = sorted((r for r in rows if r.get("loss_s") is not None
                     and r["fold"] == "modal"), key=lambda r: -r["loss_s"])
    log("hist losses at the modal folds (launches x (ms - bound)): " + ", ".join(
        f"{r['name']}/{r['caller']} {r['loss_s']:.4f} s" for r in ranked))
    (args, kw), kern, _ = captured["wedge_intersect_last"]
    last_ms = report["wedge_intersect_last_ms"] = time_ms(
        torch, lambda: kern(*args, **kw))
    fullest = next(r for r in rows if r["name"] == "wedge_intersect")
    full_ln = captured["wedge_intersect"][0][0][7]
    log(f"time wedge_intersect: fullest window {fullest['ms']:.4f} ms "
        f"({int((full_ln > 0).sum())} of {full_ln.numel()} pulled rows "
        f"non-empty), last pull superstep {last_ms:.4f} ms "
        f"({int((args[7] > 0).sum())} non-empty)")
    bins = report["full"]["fold_count_max_bins"]
    log(f"fold_count_max launches on path a by batch size: {json.dumps(bins)}")
    typical = dict(max_abs_err=errs["fold_count_max_typical"],
                   **measure(torch, "fold_count_max",
                             captured["fold_count_max_typical"]))
    report["fold_count_max_typical"] = typical
    log(f"fold_count_max at its typical fold: {json.dumps(typical)}")
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
    walls = report["phase_s"] = {}
    t_start = time.perf_counter()

    def phase(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(torch, report, *args)
        walls[name] = time.perf_counter() - t0
        return out

    phase("build", phase_build)
    phase("analysis", phase_analysis)
    phase("kernels", phase_kernels, dev)
    phase("small", phase_small, dev)
    phase("small_hub", phase_small_hub, dev)
    phase("small_delta", phase_small_delta, dev)
    phase("small_serve", phase_small_serve, dev)
    phase("small_mesh", phase_small_mesh, dev)
    phase("examples", phase_examples, dev)
    captured, launches, errs = phase("full", phase_full, FULL_SCALE, dev)
    kernels_line = {"kernels": phase("timing", phase_timing, captured,
                                     launches, errs)}
    report["total_s"] = time.perf_counter() - t_start
    log("phase walls: " + json.dumps(walls))
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
