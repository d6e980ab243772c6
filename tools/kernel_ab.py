#!/usr/bin/env python3
"""Time an earlier tree's kernels against this tree's, on the same captured
superstep inputs, on one GPU.

    git archive <commit> | tar -x -C build/old     # the earlier tree
    python3 tools/kernel_ab.py build/old [VARIANT.cu ...]

The earlier tree's ``csrc/wedge_check.cu``, ``wedge_intersect.cu`` and
``fold_scatter.cu`` are built with the same ``nvcc`` flags into
``<tree>/build/ab`` and called through their C entry points:
``tripoll_wedge_check``, ``tripoll_wedge_intersect`` and
``tripoll_ring_set`` with this tree's arguments, and the earlier
``tripoll_fold_count_max(slots, amounts, rows, B, W, cap, count, packed,
stream)`` after two ``torch.zeros`` fills of its tables inside the timed
call, as its wrapper made them. Each ``VARIANT.cu`` is another source of
the kernel its file name starts with (``wedge_check``, ``wedge_intersect``
or ``fold_scatter``, after an optional ``timing_``), with this tree's C
entry point, timed beside the two.

The inputs are captured as ``chip_smoke.py`` captures them on the
full-size deployment (R-MAT scale 18, S = 8): from a push-pull run of
DegreeTriples and Enumerate bundled, the largest wedge_check,
fold_count_max and ring_set calls and the fullest and the last pull
superstep of wedge_intersect; from a push-only DegreeTriples run, the
first fold_count_max call in the power-of-two bin of batch sizes with the
most launches (the typical fold). Each version must equal the plain
PyTorch version on them, except variants whose file name starts with
``timing_`` (parts of a kernel left out to see what the rest costs); then
they are timed in turns (earlier, this, variants, then the reverse), each
a median of CUDA-event times. Beside them: the time of filling
wedge_intersect's two [B, L] outputs (``Tensor.fill_``, the card's write
rate on those bytes), and fold_count_max's three paths (this tree's
source built so that every batch takes one block, blocks an SM or device
atomics: ``FOLD_PATHS``) on the largest and typical folds and on prefixes
of the largest fold of 2⁶ … 2²¹ elements: the crossover that sets
``FOLD_SINGLE_MAX_B``. Prints one JSON line and writes it to
``build/kernel_ab.json``.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402

# this tree's fold_scatter.cu built so that every batch takes one path
FOLD_PATHS = {"single": ("-DFOLD_SINGLE_MAX_B=" + str(2**62),),
              "blocks": ("-DFOLD_SINGLE_MAX_B=0",),
              "direct": ("-DFOLD_SINGLE_MAX_B=0", "-DFOLD_SMEM_MAX=0")}
KERNEL_OF_SOURCE = {"wedge_check": "wedge_check",
                    "wedge_intersect": "wedge_intersect",
                    "fold_scatter": "fold_count_max"}


def build(src: Path, so: Path, *defines: str):
    import ctypes

    from repro_torch.kernels import _cuda

    so.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, *defines,
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
    """A ring_set wrapper (columns) around ``lib``'s C entry point."""
    from repro_torch.kernels import _cuda
    from repro_torch.kernels.fold_scatter.ops import RING_SET_ARGTYPES

    P = _cuda.ptr
    fn = entry(lib, "tripoll_ring_set", RING_SET_ARGTYPES)

    def ring_set(prior, slots, cols, cap):
        out = torch.empty_like(prior)
        win = torch.empty(cap, dtype=torch.int32, device=slots.device)
        err = fn(P(slots), slots.shape[0], cap, P(prior), *map(P, cols),
                 *(c.stride(0) for c in cols), P(win), P(out),
                 _cuda.stream_handle(slots.device))
        _cuda.raise_on_error(label, err)
        return out
    return ring_set


def fold_count_max_call(torch, lib, label):
    """A fold_count_max wrapper around ``lib``'s C entry point (this
    tree's: one buffer, zeroed by the launcher)."""
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


def earlier_fold_count_max(torch, lib):
    """The earlier fold_count_max wrapper: two zeroed tables, then the
    kernel."""
    from repro_torch.kernels import _cuda

    P = _cuda.ptr
    fn = entry(lib, "tripoll_fold_count_max",
               [_cuda.PTR] * 3 + [_cuda.I64, _cuda.I32, _cuda.I32]
               + [_cuda.PTR] * 3)

    def fold_count_max(slots, amounts, rows, cap):
        W = rows.shape[-1]
        count = torch.zeros(cap, dtype=torch.int32, device=slots.device)
        packed = torch.zeros((cap, W), dtype=torch.int32, device=slots.device)
        err = fn(P(slots), P(amounts), P(rows), slots.shape[0], W, cap,
                 P(count), P(packed), _cuda.stream_handle(slots.device))
        _cuda.raise_on_error("earlier fold_count_max", err)
        return count, packed
    return fold_count_max


def capture(torch, dev, scale: int):
    """The captured calls: {case: ((args, kw), plain)}, and the launch
    bins of the push-only DegreeTriples run."""
    from repro_torch.core.dodgr import shard_dodgr
    from repro_torch.core.engine import survey_push_only, survey_push_pull
    from repro_torch.core.pushpull import plan_engine
    from repro_torch.core.surveys import (DegreeTriples, Enumerate,
                                          SurveyBundle)
    from repro_torch.graphs import generators
    from repro_torch.kernels.fold_scatter import ops as fs
    from repro_torch.kernels.wedge_check import ops as wc
    from repro_torch.kernels.wedge_intersect import ops as wi

    g = generators.rmat(scale, 16, seed=0, a=0.57, b=0.19,
                        c=0.19).with_degree_meta()
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
    cases = {
        "wedge_check largest": (recs[0].largest, wc.wedge_check_plain),
        "wedge_intersect fullest": (recs[1].largest,
                                    wi.wedge_intersect_plain),
        "wedge_intersect last": (recs[1].last, wi.wedge_intersect_plain),
        "fold_count_max largest": (recs[2].largest, fs.fold_count_max_plain),
        "fold_count_max typical": (bins.modal(dev), fs.fold_count_max_plain),
        "ring_set largest": (recs[3].largest, fs.ring_set_plain),
    }
    return cases, bins.counts


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
    from repro_torch.kernels.wedge_check import ops as wc
    from repro_torch.kernels.wedge_intersect import ops as wi

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    _cuda.build_all()
    tree = Path(sys.argv[1]).resolve()
    csrc = tree / "src" / "repro_torch" / "csrc"
    ab = tree / "build" / "ab"
    this = {"wedge_check": wc.wedge_check,
            "wedge_intersect": wi.wedge_intersect,
            "fold_count_max": fs.fold_count_max, "ring_set": fs.ring_set}
    earlier = {
        "wedge_check": wedge_check_call(torch, build(
            csrc / "wedge_check.cu", ab / "libwc.so"), "earlier wedge_check"),
        "wedge_intersect": wedge_intersect_call(torch, build(
            csrc / "wedge_intersect.cu", ab / "libwi.so"),
            "earlier wedge_intersect"),
    }
    lib_fs = build(csrc / "fold_scatter.cu", ab / "libfs.so")
    earlier["fold_count_max"] = earlier_fold_count_max(torch, lib_fs)
    earlier["ring_set"] = ring_set_call(torch, lib_fs, "earlier ring_set")
    calls = {"wedge_check": wedge_check_call,
             "wedge_intersect": wedge_intersect_call,
             "fold_count_max": fold_count_max_call}
    variants = {k: {} for k in calls}
    for v in map(Path, sys.argv[2:]):
        stem = v.stem.removeprefix("timing_")
        kernel = next(KERNEL_OF_SOURCE[s] for s in KERNEL_OF_SOURCE
                      if stem.startswith(s))
        lib = build(v, ROOT / "build" / "ab" / f"lib{v.stem}.so")
        variants[kernel][v.stem] = calls[kernel](torch, lib, v.stem)
    this_src = ROOT / "src" / "repro_torch" / "csrc" / "fold_scatter.cu"
    paths = {name: fold_count_max_call(torch, build(
        this_src, ROOT / "build" / "ab" / f"libfs_{name}.so", *defines),
        f"fold_count_max {name}") for name, defines in FOLD_PATHS.items()}

    cases, bins = capture(torch, dev, cs.FULL_SCALE)
    print(f"fold_count_max launch bins (push-only DegreeTriples): "
          f"{json.dumps(cs.bin_labels(bins))}", flush=True)
    rows = {}
    for label, ((args, kw), plain_fn) in cases.items():
        kernel = label.split()[0]
        if kernel == "ring_set":
            prior, slots, cols, cap = args
            fns = {"earlier": lambda: earlier["ring_set"](prior, slots, cols, cap),
                   "this": lambda: fs.ring_set(*args)}
        else:
            fns = {"earlier": lambda k=kernel: earlier[k](*args, **kw),
                   "this": lambda k=kernel: this[k](*args, **kw)}
            fns.update({name: (lambda f=f: f(*args, **kw))
                        for name, f in variants[kernel].items()})
        if kernel == "wedge_intersect":
            pos, ci = (torch.empty((args[4].shape[0], kw["L"]),
                                   dtype=torch.int32, device=dev)
                       for _ in range(2))
            fns["fill outputs"] = lambda: (pos.fill_(0), ci.fill_(0))
            ln = args[7].clamp(0, args[4].shape[1])
            print(f"{label}: {int((ln > 0).sum())} of {ln.numel()} rows "
                  f"non-empty, ln sum {int(ln.sum())}", flush=True)
        if kernel == "fold_count_max":
            fns.update({name: (lambda f=f: f(*args)) for name, f in paths.items()})
        want = plain_fn(*args, **kw)
        times = time_in_turns(torch, fns,
                              lambda got: cs.equal_outputs(got, want, torch))
        rows[label] = dict(ms=times, shapes=[cs._shape(a) for a in args])
        print(f"{label}: " + ", ".join(
            f"{name} {t[0]:.4f} {t[1]:.4f} ms" for name, t in times.items()),
            flush=True)

    # fold_count_max's two paths on prefixes of the largest fold
    (slots, amounts, rows_, cap), _ = cases["fold_count_max largest"][0]
    sweep = {}
    for k in list(range(6, 22)) + [None]:
        B = slots.shape[0] if k is None else min(2**k, slots.shape[0])
        args = (slots[:B], amounts[:B], rows_[:B], cap)
        want = fs.fold_count_max_plain(*args)
        times = time_in_turns(
            torch, {name: (lambda f=f: f(*args)) for name, f in paths.items()},
            lambda got: cs.equal_outputs(got, want, torch))
        sweep[B] = times
        print(f"fold_count_max paths at B={B}: " + ", ".join(
            f"{name} {t[0]:.4f} {t[1]:.4f} ms" for name, t in times.items()),
            flush=True)
    result = {"card": card, "kernels": rows, "fold_bins": cs.bin_labels(bins),
              "fold_paths": sweep}
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "kernel_ab.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
