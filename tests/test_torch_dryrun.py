"""The port's dry run vs the JAX package's.

- ``configs.list_archs()`` and ``launch.steps.all_cells()`` equal the
  reference's: 11 architectures, 43 cells, in order;
- every cell at CONFIG, built on the meta device: ``model_flops`` and the
  note equal to the reference's ``build_cell`` on a (1, 1) mesh, every
  argument on meta, the sorted (shape, dtype) list of the arguments equal
  to the reference's ``ShapeDtypeStruct`` leaves (uint32 lanes are int32
  in the port);
- ``roofline.count.OpCounter``: the live-bytes peak and the bytes of a toy
  call known by hand (a view, a freed temporary); memoized meta ops count
  what running every kernel counts;
- the identity ``launch/cost_correct.py`` extrapolates by, on the port's
  counts at SMOKE widths: an LM train cell's FLOPs and bytes at 3 layers
  equal r(1) + 2·(r(2) − r(1)) (AdamW and Adafactor), a tripoll cell's
  are linear in its push and pull supersteps;
- ``analyze_counted`` gives ``analyze_compiled``'s keys;
  ``roofline.report``'s tables and summary equal the reference's on the
  same records;
- ``python -m repro_torch.launch.dryrun --arch schnet --shape molecule``
  writes a record with the reference's keys;
- the kernel wrappers' meta routes give their plain versions' shapes and
  dtypes, and launch nothing;
- the twin of ``tests/test_configs_smoke.py::test_tripoll_smoke_survey``.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import configs as ref_configs
from repro.launch import steps as ref_steps
from repro.roofline import analysis as ref_analysis
from repro.roofline import report as ref_report
from repro_torch import configs
from repro_torch.launch import steps
from repro_torch.launch.dryrun import run_cell, trace_cell
from repro_torch.roofline import report
from repro_torch.roofline.analysis import HW, analyze_counted
from repro_torch.roofline.count import OpCounter

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
U32_AS = {"uint32": "int32"}      # the port's uint32 lanes are int32


def _smoke_overrides(arch, **extra):
    smoke = configs.get_arch(arch).SMOKE
    ov = {f.name: getattr(smoke, f.name) for f in dataclasses.fields(smoke)}
    ov.update(extra)
    return ov


def _counts(arch, shape, **extra):
    c = trace_cell(steps.build_cell(arch, shape,
                                    overrides=_smoke_overrides(arch, **extra)))
    return np.array([c["flops"], c["bytes"]], dtype=object)


def test_registry_and_cells_equal_reference():
    assert configs.list_archs() == ref_configs.list_archs()
    assert len(configs.list_archs()) == 11
    cells = steps.all_cells()
    assert cells == ref_steps.all_cells() and len(cells) == 43
    assert steps.all_cells(include_tripoll=False) == \
        ref_steps.all_cells(include_tripoll=False)
    for which in ("CONFIG", "SMOKE"):
        assert dataclasses.asdict(getattr(configs.get_arch("tripoll"), which)) \
            == dataclasses.asdict(getattr(ref_configs.get_arch("tripoll"), which))
    assert configs.get_arch("tripoll").KIND == "tripoll"


def test_cells_at_config_equal_reference():
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    for arch, shape in steps.all_cells():
        with mesh:
            ref = ref_steps.build_cell(arch, shape, mesh)
        plan = steps.build_cell(arch, shape)
        assert plan.model_flops == ref.model_flops, (arch, shape)
        assert plan.note == ref.note and plan.skip_reason == ref.skip_reason
        leaves = steps.tensor_leaves(plan.args)
        assert all(t.device.type == "meta" for t in leaves), (arch, shape)
        want = sorted((tuple(x.shape), U32_AS.get(str(x.dtype), str(x.dtype)))
                      for x in jax.tree.leaves(ref.args))
        got = sorted((tuple(t.shape), str(t.dtype).removeprefix("torch."))
                     for t in leaves)
        assert got == want, (arch, shape)


def test_live_peak_and_bytes_on_a_toy():
    """Storages count in the caching allocator's 512-byte blocks: 4,000 B
    take 4,096, 8,000 take 8,192, 40,000 take 40,448 and 4 take 512."""
    a = torch.empty(1000, dtype=torch.float32, device="meta")     # 4,000 B
    with OpCounter((a,)) as c:
        v = a.view(10, 100)          # a view: no bytes, no storage
        t = v * 2                    # 8,192 live
        u = t + 1                    # 12,288 live
        del t                        # freed: 8,192
        w = torch.cat([u.view(-1), a])   # 8,192 more: the peak, 16,384
        del u                        # 12,288
        x = w[:10].sum()             # a view read; 512 more
        res = c.result(x)
    assert res["peak_bytes"] == 16_384
    assert res["argument_bytes"] == 4_096 and res["output_bytes"] == 512
    # mul 4k+4k, add 4k+4k, cat 8k+8k, sum 40+4: exact; views none
    assert res["bytes"] == 16_000 + 16_000 + 44
    assert res["n_ops"] == 7 and res["flops"] == 0
    with OpCounter((a,)) as c:
        b = a.view(100, 10)
        y = b @ b.T                  # [100, 100]: 2·100·10·100 FLOPs
    assert c.flops == 200_000 and c.peak_bytes == 4_096 + 40_448
    del x, y


def test_memoized_counts_equal_running_every_kernel():
    from repro_torch.models import layers

    for arch, shape in (("tripoll", "survey_bundle"),
                        ("internlm2-1.8b", "prefill_32k")):
        res = []
        for memo in (True, False):
            layers._rope_freqs_on.cache_clear()
            plan = steps.build_cell(arch, shape, overrides=_smoke_overrides(
                arch, **({"attn_chunk": 8192} if arch != "tripoll" else {})))
            with OpCounter(plan.args, memo=memo) as c:
                out = plan.fn(*plan.args)
                r = c.result(out)
            res.append({k: v for k, v in r.items() if k != "top_ops"})
        assert res[0] == res[1], arch


@pytest.mark.parametrize("arch", ["internlm2-1.8b", "kimi-k2-1t-a32b"])
def test_lm_counts_need_no_loop_correction(arch):
    """cost_correct's LM rule, r(L) = r(1) + (r(2) − r(1))·(L − 1), holds
    exactly for the port's counts of a train cell (remat, the backward and
    the optimizer: AdamW, Adafactor for kimi-k2)."""
    r1, r2, r3 = (_counts(arch, "train_4k", n_layers=n, attn_chunk=1024)
                  for n in (1, 2, 3))
    assert (r3 == r1 + 2 * (r2 - r1)).all()
    assert (r2 != r1).all()


def test_tripoll_counts_linear_in_supersteps():
    r = {pl: _counts("tripoll", "survey_pushpull", n_push_steps=pl[0],
                     n_pull_steps=pl[1])
         for pl in ((1, 1), (2, 1), (3, 1), (1, 2), (1, 3), (2, 2))}
    push = r[(2, 1)] - r[(1, 1)]
    pull = r[(1, 2)] - r[(1, 1)]
    assert (r[(3, 1)] - r[(2, 1)] == push).all()
    assert (r[(1, 3)] - r[(1, 2)] == pull).all()
    assert (r[(2, 2)] == r[(1, 1)] + push + pull).all()
    assert (push[1] > 0) and (pull[1] > 0)


class _Compiled:
    """A stand-in for a jax ``Compiled``: what ``analyze_compiled`` reads."""

    def cost_analysis(self):
        return {"flops": 3e12, "bytes accessed": 2e9}

    def as_text(self):
        return ""

    def memory_analysis(self):
        return type("M", (), dict(argument_size_in_bytes=5, output_size_in_bytes=6,
                                  temp_size_in_bytes=7, alias_size_in_bytes=0,
                                  generated_code_size_in_bytes=0))()


def test_analyze_counted_has_the_reference_keys():
    want = ref_analysis.analyze_compiled(_Compiled(), 1, 1e12)
    counts = dict(flops=3e12, bytes=2e9, peak_bytes=18, argument_bytes=5,
                  output_bytes=6)
    got = analyze_counted(counts, 1e12)
    assert got.keys() == want.keys()
    assert got["memory"].keys() == want["memory"].keys()
    assert got["collectives"].keys() == want["collectives"].keys()
    assert got["n_devices"] == 1 and got["collectives"]["wire_bytes"] == 0
    assert got["memory"]["temp_bytes"] == 7 and got["memory"]["alias_bytes"] == 0
    hw = HW()
    assert got["terms"] == dict(compute_s=3e12 / hw.peak_flops,
                                memory_s=2e9 / hw.hbm_bw, collective_s=0.0)
    assert got["dominant"] == "compute_s" and got["fits_hbm"]
    assert not analyze_counted(dict(counts, peak_bytes=int(hw.hbm_bytes) + 1),
                               1e12)["fits_hbm"]


def test_report_equals_reference():
    recs = []
    for i, (arch, shape) in enumerate((("tripoll", "survey_push"),
                                       ("internlm2-1.8b", "long_500k"))):
        rec = analyze_counted(dict(flops=1e12 * i, bytes=3e11 + i,
                                   peak_bytes=90e9 * i + 10, argument_bytes=4,
                                   output_bytes=5), 2e11)
        rec.update(arch=arch, shape=shape, mesh="single", ok=True, note="n")
        if i:
            rec["skipped"] = "pure full-attention arch"
        recs.append(rec)
    recs.append(dict(arch="bst", shape="serve_p99", mesh="single", ok=False,
                     error="RuntimeError: x"))
    assert report.dryrun_table(recs) == ref_report.dryrun_table(recs)
    assert report.roofline_table(recs, "single") == \
        ref_report.roofline_table(recs, "single")
    assert report.summarize(recs, mesh="single") == ref_report.summarize(recs)


def test_dryrun_cli_writes_a_record(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "schnet", "--shape", "molecule", "--out", str(tmp_path)],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "[OK] schnet × molecule × card" in out.stdout
    rec = json.loads((tmp_path / "schnet__molecule__card.json").read_text())
    want = set(ref_analysis.analyze_compiled(_Compiled(), 1, 1.0)) | {
        "arch", "shape", "mesh", "note", "model_flops_total", "ok"}
    assert want <= set(rec) and rec["ok"] and rec["mesh"] == "card"
    assert rec["fits_hbm"] and rec["flops_per_device"] > 0
    assert rec["model_flops_total"] == steps.build_cell(
        "schnet", "molecule").model_flops
    bad = run_cell("schnet", "no-such-shape")
    assert not bad["ok"] and "StopIteration" in bad["error"]


def test_kernel_meta_routes_give_the_plain_shapes():
    from repro_torch.core.dodgr import dodgr_spec
    from repro_torch.kernels.fold_scatter import ops as fs
    from repro_torch.kernels.hist import ops as hist
    from repro_torch.kernels.intersect import ops as isx
    from repro_torch.kernels.wedge_check import ops as wc
    from repro_torch.kernels.wedge_intersect import ops as wi

    rng = np.random.default_rng(0)
    i32 = lambda *shape: torch.as_tensor(rng.integers(0, 8, shape, dtype=np.int32))
    B, W, L, cap = 9, 3, 5, 16
    calls = [
        (wc.wedge_check, (i32(2, 20),) * 3 + (i32(2, 7),) * 5, {}),
        (wi.wedge_intersect, (i32(20),) * 3 + (i32(B),) + (i32(B, 4),) * 3
         + (i32(B),), dict(L=L)),
        (isx.intersect, (i32(B, L),) * 3 + (i32(B),) + (i32(B, L),) * 3, {}),
        (hist.hist_add, (i32(B), i32(B), cap), {}),
        (hist.hist_max, (i32(B), i32(B, W), cap), {}),
        (fs.fold_count_max, (i32(B), i32(B), i32(B, W), cap), {}),
        (fs.ring_set, (i32(cap, 3), i32(B), i32(B, 3), cap), {}),
    ]
    before = [wc.launches, wi.launches, isx.launches, hist.hist_add_launches,
              hist.hist_max_launches, fs.launches, fs.ring_set_launches]
    for fn, args, kw in calls:
        plain = fn(*args, **kw)
        meta = fn(*(a.to("meta") if isinstance(a, torch.Tensor) else a
                    for a in args), **kw)
        for p, m in zip(plain if isinstance(plain, tuple) else (plain,),
                        meta if isinstance(meta, tuple) else (meta,)):
            assert m.device.type == "meta"
            assert (m.shape, m.dtype) == (p.shape, p.dtype), fn.__name__
    assert [wc.launches, wi.launches, isx.launches, hist.hist_add_launches,
            hist.hist_max_launches, fs.launches, fs.ring_set_launches] == before
    # dodgr_spec: the reference's shapes; zeros (an empty graph) off meta
    from repro.core.dodgr import dodgr_spec as ref_spec

    args = (2, 64, 32, 100, 8, 1, 2, 0, 1)
    gr = dodgr_spec(*args, hub_theta=3, n_hubs=2, hub_len=4, device="cpu")
    ref = ref_spec(*args, hub_theta=3, n_hubs=2, hub_len=4)
    for f in dataclasses.fields(gr):
        v = getattr(gr, f.name)
        if isinstance(v, torch.Tensor):
            rv = getattr(ref, f.name)
            assert tuple(v.shape) == rv.shape, f.name
            assert str(v.dtype)[6:] == U32_AS.get(str(rv.dtype), str(rv.dtype))
            assert not v.any()
        else:
            assert v == getattr(ref, f.name), f.name


def test_tripoll_smoke_survey_twin():
    """``tests/test_configs_smoke.py::test_tripoll_smoke_survey`` on the
    port: push-pull on rmat(7, 8, seed=2), S = 4."""
    from repro.core.ref import count_triangles_ref as ref_count
    from repro.graphs import generators as ref_generators
    from repro_torch.core.dodgr import shard_dodgr
    from repro_torch.core.engine import survey_push_pull
    from repro_torch.core.pushpull import plan_engine
    from repro_torch.core.ref import count_triangles_ref
    from repro_torch.core.surveys import TriangleCount
    from repro_torch.graphs import generators

    g = generators.rmat(7, 8, seed=2)
    gr, _ = shard_dodgr(g, S=4, device="cpu")
    cfg, _ = plan_engine(g, 4, mode="pushpull")
    res, st = survey_push_pull(gr, TriangleCount(), cfg)
    assert res == count_triangles_ref(g) == ref_count(ref_generators.rmat(7, 8, seed=2))
    assert st["pull_overflow"] == 0
