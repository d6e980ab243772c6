#!/usr/bin/env python3
"""Time an earlier tree's wedge_intersect and ring_set kernels against this
tree's, on the same captured superstep inputs, on one GPU.

    git archive <commit> | tar -x -C build/old     # the earlier tree
    python3 tools/kernel_ab.py build/old [VARIANT.cu ...]

The earlier tree's ``csrc/wedge_intersect.cu`` and ``csrc/fold_scatter.cu``
are built with the same ``nvcc`` flags into ``<tree>/build/ab`` and called
through their C entry points as the first designs took them
(``tripoll_wedge_intersect`` with this tree's arguments;
``tripoll_ring_set(slots, rows [B, 3], B, cap, win, out, stream)`` after a
clone of the prior table into ``out`` and a fill of ``win`` with -1, both
timed, as that wrapper did them). The inputs are captured, as
``chip_smoke.py`` captures them, from a push-pull run of DegreeTriples and
Enumerate bundled on the full-size deployment (R-MAT scale 18, S = 8);
the fullest and the last pull superstep of wedge_intersect and the
largest ring_set call. Each ``VARIANT.cu`` is another wedge_intersect
source with this tree's C entry point, timed beside the two. Each version
must equal the plain PyTorch version on them, except variants whose file
name starts with ``timing_`` (parts of a kernel left out to see what the
rest costs); then they are timed in turns (earlier, this, variants, then
the reverse), each a median of CUDA-event times. Beside them: the time of
filling the two [B, L] outputs (``Tensor.fill_``, the card's write rate on
those bytes) and the window's row lengths. Prints one JSON line and
writes it to ``build/kernel_ab.json``.
"""
from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as cs  # noqa: E402


def build(src: Path, so: Path) -> ctypes.CDLL:
    from repro_torch.kernels import _cuda

    so.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-o", str(so),
                           str(src)], capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
    for line in proc.stdout.splitlines() + proc.stderr.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas {src.name}: {line.strip()}", flush=True)
    return ctypes.CDLL(str(so))


def wedge_intersect_call(torch, lib, label):
    """A wedge_intersect wrapper around ``lib``'s C entry point."""
    from repro_torch.kernels import _cuda

    P = _cuda.ptr
    fn = lib.tripoll_wedge_intersect
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_void_p] * 5
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
                   + [ctypes.c_void_p] * 3)

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


def earlier_ring_set(torch, lib):
    """The first ring_set design's wrapper around ``lib``'s entry point."""
    from repro_torch.kernels import _cuda

    P = _cuda.ptr
    rs = lib.tripoll_ring_set
    rs.restype = ctypes.c_int
    rs.argtypes = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_int]
                   + [ctypes.c_void_p] * 3)

    def ring_set(prior, slots, rows, cap):
        out = prior.clone()
        win = torch.full((cap,), -1, dtype=torch.int32, device=slots.device)
        err = rs(P(slots), P(rows), slots.shape[0], cap, P(win), P(out),
                 _cuda.stream_handle(slots.device))
        _cuda.raise_on_error("earlier ring_set", err)
        return out
    return ring_set


def capture(torch, dev, scale: int):
    from repro_torch.core.dodgr import shard_dodgr
    from repro_torch.core.engine import survey_push_pull
    from repro_torch.core.pushpull import plan_engine
    from repro_torch.core.surveys import (DegreeTriples, Enumerate,
                                          SurveyBundle)
    from repro_torch.graphs import generators
    from repro_torch.kernels.fold_scatter import ops as fs
    from repro_torch.kernels.wedge_intersect import ops as wi

    g = generators.rmat(scale, 16, seed=0, a=0.57, b=0.19,
                        c=0.19).with_degree_meta()
    gr, _ = shard_dodgr(g, 8, device=dev)
    cfg, _ = plan_engine(g, 8, DegreeTriples(capacity=4096), mode="pushpull",
                         push_cap=4096, pull_q_cap=16)
    recs = [cs.Recorder(wi, "wedge_intersect", torch),
            cs.Recorder(fs, "ring_set", torch)]
    survey_push_pull(gr, SurveyBundle([DegreeTriples(capacity=4096),
                                       Enumerate(capacity=2**20)]), cfg)
    for r in recs:
        r.restore()
    return recs


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
    from repro_torch.kernels.wedge_intersect import ops as wi

    dev = torch.device("cuda", 0)
    card = cs.card_line()
    _cuda.build_all()
    tree = Path(sys.argv[1]).resolve()
    csrc = tree / "src" / "repro_torch" / "csrc"
    old_wi = wedge_intersect_call(torch, build(
        csrc / "wedge_intersect.cu", tree / "build" / "ab" / "libwi.so"),
        "earlier wedge_intersect")
    old_rs = earlier_ring_set(torch, build(
        csrc / "fold_scatter.cu", tree / "build" / "ab" / "libfs.so"))
    variants = {}
    for v in map(Path, sys.argv[2:]):
        so = ROOT / "build" / "ab" / f"lib{v.stem}.so"
        variants[v.stem] = wedge_intersect_call(torch, build(v, so), v.stem)
    rec_wi, rec_rs = capture(torch, dev, cs.FULL_SCALE)
    cases = {"wedge_intersect fullest": rec_wi.largest,
             "wedge_intersect last": rec_wi.last,
             "ring_set largest": rec_rs.largest}
    rows = {}
    for label, (args, kw) in cases.items():
        if label.startswith("ring_set"):
            prior, slots, cols, cap = args
            stacked = torch.stack(cols, -1)
            fns = {"earlier": lambda: old_rs(prior, slots, stacked, cap),
                   "this": lambda: fs.ring_set(*args)}
            plain = fs.ring_set_plain(*args)
        else:
            fns = {"earlier": lambda: old_wi(*args, **kw),
                   "this": lambda: wi.wedge_intersect(*args, **kw)}
            fns.update({name: (lambda f=f: f(*args, **kw))
                        for name, f in variants.items()})
            pos, ci = (torch.empty((args[4].shape[0], kw["L"]),
                                   dtype=torch.int32, device=dev)
                       for _ in range(2))
            fns["fill outputs"] = lambda: (pos.fill_(0), ci.fill_(0))
            plain = wi.wedge_intersect_plain(*args, **kw)
            ln = args[7].clamp(0, args[4].shape[1])
            print(f"{label}: {int((ln > 0).sum())} of {ln.numel()} rows "
                  f"non-empty, ln sum {int(ln.sum())}", flush=True)
        for name, f in fns.items():
            if not name.startswith(("timing_", "fill")):
                cs.equal_outputs(f(), plain, torch)
        order = list(fns) + list(fns)[::-1]
        times = {name: [] for name in fns}
        for name in order:
            times[name].append(cs.time_ms(torch, fns[name]))
        rows[label] = dict(ms=times, shapes=[cs._shape(a) for a in args])
        print(f"{label}: " + ", ".join(
            f"{name} {t[0]:.4f} {t[1]:.4f} ms" for name, t in times.items()),
            flush=True)
    result = {"card": card, "kernels": rows}
    out = ROOT / "build"
    out.mkdir(exist_ok=True)
    (out / "kernel_ab.json").write_text(json.dumps(result, indent=1))
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
