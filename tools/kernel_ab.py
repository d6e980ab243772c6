#!/usr/bin/env python3
"""Time an earlier tree's kernels against this tree's, on the same captured
superstep inputs, on one GPU.

    git archive <commit> | tar -x -C build/old     # the earlier tree
    python3 tools/kernel_ab.py build/old [VARIANT.cu ...]

The earlier tree's ``csrc/wedge_check.cu``, ``wedge_intersect.cu``,
``fold_scatter.cu`` and ``hist.cu`` are built with the same ``nvcc`` flags
into ``<tree>/build/ab`` and called through their C entry points with this
tree's arguments: ``tripoll_wedge_check``, ``tripoll_wedge_intersect``,
``tripoll_ring_set`` and ``tripoll_fold_count_max`` (one table buffer,
zeroed by its launcher); ``tripoll_hist_add`` and ``tripoll_hist_max``
after a ``torch.zeros`` fill of their table inside the timed call, as the
earlier wrapper made it. Each ``VARIANT.cu`` is another source of the
kernels its file name starts with (``wedge_check``, ``wedge_intersect``,
``fold_scatter`` or ``hist``, after an optional ``timing_``), with this
tree's C entry points, built with this tree's ``csrc`` on the include
path and timed beside the two.

The inputs are captured on the full-size deployment of ``chip_smoke.py``
(R-MAT scale 18, S = 8): from a push-pull run of DegreeTriples and
Enumerate bundled, the largest wedge_check, fold_count_max and ring_set
calls and the fullest and the last pull superstep of wedge_intersect;
from a push-only DegreeTriples run, the first fold_count_max call in the
power-of-two bin of batch sizes with the most launches (the typical
fold); from a window of the metadata bundle of all eight built-ins
(every push superstep and the first ``BUNDLE_PULL_STEPS`` pull
supersteps), each hist caller's first call in each power-of-two bin of
batch sizes (timed for the two trees only) and its largest fold, and the
hist pair on
DegreeTriples' largest fold operands (a shape no real call has: the one
earlier PRs timed); and fold_count_max on that fold's slots with rows of
16 words (this tree and the fold paths only: an earlier tree that stages
every row has no route for them), and with 2¹⁶ slots, a table too large
for shared memory, at W = 5 and 14 (and uniform slots at W = 5). Each
version must equal the plain PyTorch version on
them, except variants whose file name starts with ``timing_`` (parts of a
kernel left out to see what the rest costs); then they are timed in turns
(earlier, this, variants, then the reverse), each a median of CUDA-event
times. Beside them: the time of filling wedge_intersect's two [B, L]
outputs (``Tensor.fill_``, the card's write rate on those bytes), and the
three paths of the fold body, each forced whatever the batch size
(``tools/variants/fold_paths.cu``: one block where the table fits in
shared memory, blocks, on table slices where it does not, and device
atomics), on each fold case and on prefixes of 2⁶ … elements of
fold_count_max's and each hist caller's largest fold: the crossovers that
set the launchers' limits (``kFoldSingleMaxB``, ``kAdd*MaxB``,
``kMaxSingleMaxB``). Prints each timing as it is taken and writes them
all to ``build/kernel_ab.json``.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

CSRC = ROOT / "src" / "repro_torch" / "csrc"
BUNDLE_PULL_STEPS = 16     # pull supersteps in the bundle's capture window
PATHS = ("single", "blocks", "direct")   # tripoll_fold_path's path codes
# the fold each kernel makes (tripoll_fold_path's kind), and the elements a
# block its blocks path takes (as the launchers set them: kFoldPerBlock,
# kAddPerBlock; hist_max's launcher has no blocks path)
FOLD_KINDS = {"fold_count_max": (0, 16384), "hist_add": (1, 2048),
              "hist_max": (2, 1024)}
HIST_KERNELS = ("hist_add", "hist_max")


def build(src: Path, so: Path):
    import ctypes

    from repro_torch.kernels import _cuda

    so.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(CSRC),
                           "-o", str(so), str(src)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    for line in proc.stdout.splitlines() + proc.stderr.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas {so.name}: {line.strip()}", flush=True)
    return ctypes.CDLL(str(so))


def entry(lib, name, argtypes):
    import ctypes

    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def wedge_check_call(torch, lib, label):
    """A wedge_check wrapper around ``lib``'s C entry point."""
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.wedge_check.ops import ARGTYPES

    P = _cuda.ptr
    fn = entry(lib, "tripoll_wedge_check", ARGTYPES)

    def wedge_check(kd, kh, ki, lo, hi, qd, qh, qi):
        S, E = kd.shape
        out = torch.empty_like(lo)
        err = fn(P(kd), P(kh), P(ki), S, E, P(lo), P(hi), P(qd), P(qh),
                 P(qi), lo.shape[-1], P(out), _cuda.stream_handle(kd.device))
        _cuda.raise_on_error(label, err)
        return out
    return wedge_check


def wedge_intersect_call(torch, lib, label):
    """A wedge_intersect wrapper around ``lib``'s C entry point."""
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.wedge_intersect.ops import ARGTYPES

    P = _cuda.ptr
    fn = entry(lib, "tripoll_wedge_intersect", ARGTYPES)

    def wedge_intersect(kd, kh, ki, e, rd, rh, ri, ln, L):
        B, Lr = rd.shape
        pos = torch.empty((B, L), dtype=torch.int32, device=kd.device)
        ci = torch.empty_like(pos)
        err = fn(P(kd), P(kh), P(ki), kd.shape[0], P(e), P(rd), P(rh), P(ri),
                 P(ln), B, Lr, L, P(pos), P(ci),
                 _cuda.stream_handle(kd.device))
        _cuda.raise_on_error(label, err)
        return pos, ci
    return wedge_intersect


def ring_set_call(torch, lib, label):
    """A ring_set wrapper (columns or [B, 3] rows) around ``lib``'s C entry
    point."""
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.fold_scatter.ops import RING_SET_ARGTYPES

    P = _cuda.ptr
    fn = entry(lib, "tripoll_ring_set", RING_SET_ARGTYPES)

    def ring_set(prior, slots, rows, cap):
        cols = tuple(rows) if isinstance(rows, tuple) else rows.unbind(-1)
        out = torch.empty_like(prior)
        win = torch.empty(cap, dtype=torch.int32, device=slots.device)
        err = fn(P(slots), slots.shape[0], cap, P(prior), *map(P, cols),
                 *(c.stride(0) for c in cols), P(win), P(out),
                 _cuda.stream_handle(slots.device))
        _cuda.raise_on_error(label, err)
        return out
    return ring_set


def fold_count_max_call(torch, lib, label):
    """A fold_count_max wrapper around ``lib``'s C entry point (one buffer,
    zeroed by the launcher)."""
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.fold_scatter.ops import FOLD_COUNT_MAX_ARGTYPES

    P = _cuda.ptr
    fn = entry(lib, "tripoll_fold_count_max", FOLD_COUNT_MAX_ARGTYPES)

    def fold_count_max(slots, amounts, rows, cap):
        W = rows.shape[-1]
        table = torch.empty(cap * (W + 1), dtype=torch.int32,
                            device=slots.device)
        err = fn(P(slots), P(amounts), P(rows), slots.shape[0], W, cap,
                 P(table), _cuda.stream_handle(slots.device))
        _cuda.raise_on_error(label, err)
        return table[:cap], table[cap:].view(cap, W)
    return fold_count_max


def hist_add_call(torch, lib, label, zeroed=False):
    """A hist_add wrapper around ``lib``'s C entry point; ``zeroed``: the
    table is a ``torch.zeros`` fill (the earlier wrapper's), else
    ``torch.empty`` (the launcher zeroes it where it must)."""
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.hist.ops import HIST_ADD_ARGTYPES

    P = _cuda.ptr
    fn = entry(lib, "tripoll_hist_add", HIST_ADD_ARGTYPES)
    new = torch.zeros if zeroed else torch.empty

    def hist_add(slots, amounts, cap):
        count = new(cap, dtype=torch.int32, device=slots.device)
        err = fn(P(slots), P(amounts), slots.shape[0], cap, P(count),
                 _cuda.stream_handle(slots.device))
        _cuda.raise_on_error(label, err)
        return count
    return hist_add


def hist_max_call(torch, lib, label, zeroed=False):
    """A hist_max wrapper around ``lib``'s C entry point (``zeroed`` as
    for :func:`hist_add_call`)."""
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.hist.ops import HIST_MAX_ARGTYPES

    P = _cuda.ptr
    fn = entry(lib, "tripoll_hist_max", HIST_MAX_ARGTYPES)
    new = torch.zeros if zeroed else torch.empty

    def hist_max(slots, rows, cap):
        W = rows.shape[-1]
        packed = new((cap, W), dtype=torch.int32, device=slots.device)
        err = fn(P(slots), P(rows), slots.shape[0], W, cap, P(packed),
                 _cuda.stream_handle(slots.device))
        _cuda.raise_on_error(label, err)
        return packed
    return hist_max


def fold_paths(torch, lib) -> dict:
    """{kernel: {path: wrapper}}: the kernel's fold forced onto each path
    of the fold body (``tools/variants/fold_paths.cu``); a wrapper returns
    None where its path does not apply (one block on a table too large for
    shared memory)."""
    import ctypes

    from repro_torch.kernels import _cuda

    P = _cuda.ptr
    fits = entry(lib, "tripoll_fold_fits", [_cuda.I32] * 3)
    fn = entry(lib, "tripoll_fold_path", [_cuda.I32] * 2 + [_cuda.PTR] * 3
               + [_cuda.I64, _cuda.I32, _cuda.I32, _cuda.PTR, _cuda.I64,
                  _cuda.PTR])
    null = ctypes.c_void_p(0)

    def wrapper(kernel, kind, per_block, code):
        def run(*args):
            slots, cap = args[0], args[-1]
            amounts = args[1] if kernel != "hist_max" else None
            rows = args[-2] if kernel != "hist_add" else None
            W = rows.shape[-1] if rows is not None else 0
            if code == 0 and not fits(kind, W, cap):
                return None
            words = cap * ((kernel != "hist_max") + W)
            table = torch.empty(words, dtype=torch.int32, device=slots.device)
            err = fn(kind, code, P(slots),
                     P(amounts) if amounts is not None else null,
                     P(rows) if rows is not None else null, slots.shape[0], W,
                     cap, P(table), per_block,
                     _cuda.stream_handle(slots.device))
            _cuda.raise_on_error(f"{kernel} {PATHS[code]}", err)
            if kernel == "hist_add":
                return table
            if kernel == "hist_max":
                return table.view(cap, W)
            return table[:cap], table[cap:].view(cap, W)
        return run

    return {kernel: {name: wrapper(kernel, kind, per_block, code)
                     for code, name in enumerate(PATHS)}
            for kernel, (kind, per_block) in FOLD_KINDS.items()}


CALLS = {"wedge_check": wedge_check_call,
         "wedge_intersect": wedge_intersect_call,
         "fold_count_max": fold_count_max_call, "ring_set": ring_set_call,
         "hist_add": hist_add_call, "hist_max": hist_max_call}


def kernels_of(torch, lib, label, zeroed=False) -> dict:
    """Wrappers of every kernel ``lib`` exports a C entry point for."""
    out = {}
    for kernel, call in CALLS.items():
        if hasattr(lib, f"tripoll_{kernel}"):
            kw = dict(zeroed=zeroed) if kernel in HIST_KERNELS else {}
            out[kernel] = call(torch, lib, f"{label} {kernel}", **kw)
    return out


def capture(torch, dev, scale: int):
    """The captured calls: {case: ((args, kw), plain)}, the launch bins of
    the push-only DegreeTriples run and those of each hist caller in the
    bundle's window."""
    from repro_torch.core.dodgr import shard_dodgr
    from repro_torch.core.engine import survey_push_only, survey_push_pull
    from repro_torch.core.pushpull import plan_engine
    from repro_torch.core.surveys import (DegreeTriples, Enumerate,
                                          SurveyBundle)
    from repro_torch.graphs import generators
    from repro_torch.kernels.fold_scatter import ops as fs
    from repro_torch.kernels.hist import ops as hist
    from repro_torch.kernels.wedge_check import ops as wc
    from repro_torch.kernels.wedge_intersect import ops as wi

    base = generators.rmat(scale, 16, seed=0, a=0.57, b=0.19, c=0.19)
    g = base.with_degree_meta()
    gr, _ = shard_dodgr(g, 8, device=dev)
    dt = DegreeTriples(capacity=4096)
    cfg, _ = plan_engine(g, 8, dt, mode="pushpull", push_cap=4096,
                         pull_q_cap=16)
    recs = [cs.Recorder(wc, "wedge_check", torch),
            cs.Recorder(wi, "wedge_intersect", torch),
            cs.Recorder(fs, "fold_count_max", torch),
            cs.Recorder(fs, "ring_set", torch)]
    survey_push_pull(gr, SurveyBundle([dt, Enumerate(capacity=2**20)]), cfg)
    for r in recs:
        r.restore()
    cfg_push, _ = plan_engine(g, 8, dt, mode="push", push_cap=4096,
                              pull_q_cap=16)
    bins = cs.LaunchBins(fs, "fold_count_max")
    survey_push_only(gr, dt, cfg_push)
    bins.restore()
    del gr

    # the bundle's window: every push superstep, the first pull supersteps
    g_lab = cs.survey_meta(base, seed=1)
    gr_lab, _ = shard_dodgr(g_lab, 8, device=dev)
    bundle = cs.bundle_of_all(g_lab.n, enum_cap=2**20)
    cfg_b, _ = plan_engine(g_lab, 8, bundle, mode="pushpull", push_cap=4096,
                           pull_q_cap=16)
    window = dataclasses.replace(cfg_b, n_pull_steps=BUNDLE_PULL_STEPS)
    hist_bins = {k: cs.LaunchBins(hist, k) for k in HIST_KERNELS}
    with warnings.catch_warnings(), cs.tag_updates(bundle,
                                                   list(hist_bins.values())):
        warnings.simplefilter("ignore", RuntimeWarning)   # inexact by design
        survey_push_pull(gr_lab, bundle, window)
    for b in hist_bins.values():
        b.restore()
    del gr_lab

    fold = recs[2].largest
    cases = {
        "wedge_check largest": (recs[0].largest, wc.wedge_check_plain),
        "wedge_intersect fullest": (recs[1].largest,
                                    wi.wedge_intersect_plain),
        "wedge_intersect last": (recs[1].last, wi.wedge_intersect_plain),
        "fold_count_max largest": (fold, fs.fold_count_max_plain),
        "fold_count_max typical": (bins.modal(dev), fs.fold_count_max_plain),
        "ring_set largest": (recs[3].largest, fs.ring_set_plain),
    }
    for k, b in hist_bins.items():
        plain = getattr(hist, f"{k}_plain")
        for caller, rec in sorted(b.by_caller.items(), key=str):
            for j in sorted(rec["first"]):
                cases[f"{k} {caller} 2^{j}"] = ((cs._on(rec["first"][j], dev),
                                                {}), plain)
            cases[f"{k} {caller} largest"] = (b.largest(dev, caller), plain)
    slots, amounts, rows, cap = fold[0]
    # the largest fold's slots with rows of 16 words (no real call): the
    # earlier tree staged every row and has no route for W >= 15
    rows16 = torch.as_tensor(np.random.default_rng(5).integers(
        0, 2**32, (slots.shape[0], 16), dtype=np.uint64).astype(np.uint32)
        .view(np.int32), device=dev)
    cases["fold_count_max W16"] = (((slots, amounts, rows16, cap), {}),
                                   fs.fold_count_max_plain)
    # tables too large for shared memory with rows of W <= 14 words (no
    # real call of the cells has one): the largest fold's slots into 2^16
    # slots, at W = 5 and 14, and uniform slots at W = 5
    big = 1 << 16
    rows14 = torch.as_tensor(np.random.default_rng(7).integers(
        0, 2**32, (slots.shape[0], 14), dtype=np.uint64).astype(np.uint32)
        .view(np.int32), device=dev)
    uniform = torch.as_tensor(np.random.default_rng(6).integers(
        0, big, slots.shape[0], dtype=np.int32), device=dev)
    for label, case in (("W5 cap65536", (slots, amounts, rows, big)),
                        ("W5 cap65536 uniform", (uniform, amounts, rows, big)),
                        ("W14 cap65536", (slots, amounts, rows14, big))):
        cases[f"fold_count_max {label}"] = ((case, {}), fs.fold_count_max_plain)
    cases["hist_add DegreeTriples-shape"] = (((slots, amounts, cap), {}),
                                             hist.hist_add_plain)
    cases["hist_max DegreeTriples-shape"] = (((slots, rows, cap), {}),
                                             hist.hist_max_plain)
    hist_counts = {k: {c: cs.bin_labels(b.counts(c)) for c in b.by_caller}
                   for k, b in hist_bins.items()}
    return cases, bins.counts(), hist_counts


def applicable(paths, kernel, args, kw) -> dict:
    """The fold paths of ``kernel`` that apply to these operands, as
    functions of no arguments."""
    return {name: (lambda f=f: f(*args, **kw))
            for name, f in paths.get(kernel, {}).items()
            if f(*args, **kw) is not None}


def time_in_turns(torch, fns, check=None):
    """Each function's times, forward then in reverse, after checking every
    one not named ``timing_*`` or ``fill*`` with ``check``."""
    for name, f in fns.items():
        if check is not None and not name.startswith(("timing_", "fill")):
            check(f())
    order = list(fns) + list(fns)[::-1]
    times = {name: [] for name in fns}
    for name in order:
        times[name].append(cs.time_ms(torch, fns[name]))
    return times


def main() -> int:
    if len(sys.argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.fold_scatter import ops as fs
    from repro_torch.kernels.hist import ops as hist
    from repro_torch.kernels.wedge_check import ops as wc
    from repro_torch.kernels.wedge_intersect import ops as wi

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    _cuda.build_all()
    tree = Path(sys.argv[1]).resolve()
    ab = tree / "build" / "ab"
    this = {"wedge_check": wc.wedge_check,
            "wedge_intersect": wi.wedge_intersect,
            "fold_count_max": fs.fold_count_max, "ring_set": fs.ring_set,
            "hist_add": hist.hist_add, "hist_max": hist.hist_max}
    earlier = {}
    for src in ("wedge_check", "wedge_intersect", "fold_scatter", "hist"):
        lib = build(tree / "src" / "repro_torch" / "csrc" / f"{src}.cu",
                    ab / f"lib{src}.so")
        earlier.update(kernels_of(torch, lib, "earlier", zeroed=True))
    variants = {k: {} for k in this}
    for v in sys.argv[2:]:
        name = Path(v).stem
        lib = build(Path(v), ROOT / "build" / "ab" / f"lib{name}.so")
        for kernel, f in kernels_of(torch, lib, name).items():
            variants[kernel][name] = f
    paths = fold_paths(torch, build(ROOT / "tools" / "variants" /
                                    "fold_paths.cu",
                                    ROOT / "build" / "ab" / "libfold_paths.so"))

    cases, bins, hist_bins = capture(torch, dev, cs.FULL_SCALE)
    print(f"fold_count_max launch bins (push-only DegreeTriples): "
          f"{json.dumps(cs.bin_labels(bins))}", flush=True)
    print(f"hist launch bins by caller (bundle window of every push and "
          f"{BUNDLE_PULL_STEPS} pull supersteps): {json.dumps(hist_bins)}",
          flush=True)
    rows = {}
    for label, ((args, kw), plain_fn) in cases.items():
        kernel = label.split()[0]
        fns = {"earlier": lambda k=kernel: earlier[k](*args, **kw),
               "this": lambda k=kernel: this[k](*args, **kw)}
        if label == "fold_count_max W16":
            del fns["earlier"]
        if " 2^" not in label:   # a bin's first call: the two trees only
            fns.update({name: (lambda f=f: f(*args, **kw))
                        for name, f in variants[kernel].items()})
            fns.update(applicable(paths, kernel, args, kw))
        if kernel == "wedge_intersect":
            pos, ci = (torch.empty((args[4].shape[0], kw["L"]),
                                   dtype=torch.int32, device=dev)
                       for _ in range(2))
            fns["fill outputs"] = lambda: (pos.fill_(0), ci.fill_(0))
            ln = args[7].clamp(0, args[4].shape[1])
            print(f"{label}: {int((ln > 0).sum())} of {ln.numel()} rows "
                  f"non-empty, ln sum {int(ln.sum())}", flush=True)
        want = plain_fn(*args, **kw)
        times = time_in_turns(torch, fns,
                              lambda got: cs.equal_outputs(got, want, torch))
        rows[label] = dict(ms=times, shapes=[cs._shape(a) for a in args])
        print(f"{label}: " + ", ".join(
            f"{name} {t[0]:.4f} {t[1]:.4f} ms" for name, t in times.items()),
            flush=True)

    # the earlier kernel and the fold paths on prefixes of each fold's
    # largest call: the limits between the paths
    sweep = {}
    for label, ((args, kw), plain_fn) in cases.items():
        kernel = label.split()[0]
        if not (label.endswith("largest") and paths.get(kernel)):
            continue
        n = args[0].shape[0]
        sweep[label] = {}
        for B in sorted({min(2**k, n) for k in range(6, n.bit_length())} | {n}):
            cut = tuple(a[:B] if hasattr(a, "shape") else a for a in args)
            want = plain_fn(*cut)
            fns = {"earlier": lambda k=kernel: earlier[k](*cut),
                   "this": lambda k=kernel: this[k](*cut)}
            fns.update(applicable(paths, kernel, cut, {}))
            fns.update({name: (lambda f=f: f(*cut))
                        for name, f in variants[kernel].items()})
            times = time_in_turns(
                torch, fns, lambda got: cs.equal_outputs(got, want, torch))
            sweep[label][B] = times
            print(f"{label} paths at B={B}: " + ", ".join(
                f"{name} {t[0]:.4f} {t[1]:.4f} ms"
                for name, t in times.items()), flush=True)
    result = {"card": card, "kernels": rows, "fold_bins": cs.bin_labels(bins),
              "hist_bins": hist_bins, "bundle_pull_steps": BUNDLE_PULL_STEPS,
              "paths": sweep}
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "kernel_ab.json").write_text(json.dumps(result, indent=1))
    print(f"wrote {out / 'kernel_ab.json'}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
