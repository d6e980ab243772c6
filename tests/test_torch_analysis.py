"""The port's static verifier (``repro_torch.analysis``) against the JAX
package's (``repro.analysis``): the same fold-contract codes for four
broken surveys, each written for both packages, and the 9 built-ins; the
same conservation codes for clean exchanges and for the reference's
seeded breakages; the same plan-audit codes for small plans (hub, mesh
and bucketed cells), a hand-edited plan and delta plans; and the port's
CLI green. Lint rules: tests/test_torch_lint.py."""
import dataclasses

import numpy as np
import pytest
import torch

from repro import analysis as ref_an
from repro.comm import exchange as ref_ex
from repro.core import pushpull as ref_pp
from repro.core import surveys as ref_sv
from repro.graphs import csr as ref_csr
from repro.graphs import generators as ref_gen
from repro_torch import analysis as pt_an
from repro_torch.comm import exchange as pt_ex
from repro_torch.core import pushpull as pt_pp
from repro_torch.core import surveys as pt_sv
from repro_torch.graphs import csr as pt_csr
from repro_torch.graphs import generators as pt_gen
from test_analysis import (CarryShapeDrift, CarryStructureDrift,
                           EpochDtypeDrift, OrderSensitiveFloat)

# one intra-op thread: the suite runs in parallel workers
torch.set_num_threads(1)

PKG = {"ref": (ref_an, ref_ex, ref_pp, ref_sv, ref_csr, ref_gen),
       "pt": (pt_an, pt_ex, pt_pp, pt_sv, pt_csr, pt_gen)}


def codes(violations) -> set[str]:
    return {v.code for v in violations}


# ---------------------------------------------------------------------------
# the reference's four broken fixture surveys (tests/test_analysis.py), in
# the port's idiom


class PtOrderSensitiveFloat(pt_sv.Survey):
    """Float scatter-add fold: only the determinism verdict fails."""

    meta_spec = pt_sv.MetaSpec.edges(f=(0,))

    def init(self, device):
        return torch.zeros(16, dtype=torch.float32, device=device)

    def update(self, state, tri):
        w = torch.where(tri.valid, tri.e_pq_f[:, 0], 0.0)
        return state.index_add(0, (tri.p % 16).long(), w)

    def merge(self, stacked):
        return stacked.sum(0)


class PtEpochDtypeDrift(pt_sv.Survey):
    """merge_epochs silently promotes the accumulator to float32."""

    meta_spec = pt_sv.MetaSpec.none()

    def init(self, device):
        return torch.zeros((), dtype=torch.int32, device=device)

    def update(self, state, tri):
        return state + tri.valid.sum().to(torch.int32)

    def merge(self, stacked):
        return stacked.sum(0).to(torch.int32)

    def merge_epochs(self, prev, delta):
        return (prev + delta).to(torch.float32)


class PtCarryShapeDrift(pt_sv.Survey):
    """update grows its own state."""

    meta_spec = pt_sv.MetaSpec.none()

    def init(self, device):
        return torch.zeros(4, dtype=torch.int32, device=device)

    def update(self, state, tri):
        return torch.cat([state, tri.valid.sum()[None].to(torch.int32)])

    def merge(self, stacked):
        return stacked.sum(0, dtype=torch.int32)


class PtCarryStructureDrift(pt_sv.Survey):
    """update returns a different structure than init."""

    meta_spec = pt_sv.MetaSpec.none()

    def init(self, device):
        return {"n": torch.zeros((), dtype=torch.int32, device=device)}

    def update(self, state, tri):
        return (state["n"] + tri.valid.sum().to(torch.int32),)

    def merge(self, stacked):
        return stacked


FIXTURES = {
    "OrderSensitiveFloat": (OrderSensitiveFloat, PtOrderSensitiveFloat,
                            set()),
    "EpochDtypeDrift": (EpochDtypeDrift, PtEpochDtypeDrift,
                        {"epoch-merge-dtype-drift"}),
    "CarryShapeDrift": (CarryShapeDrift, PtCarryShapeDrift,
                        {"fold-carry-shape-drift"}),
    "CarryStructureDrift": (CarryStructureDrift, PtCarryStructureDrift,
                            {"fold-carry-structure"}),
}
BUILTINS = [name for name, _ in pt_an.builtin_surveys()]


@pytest.mark.parametrize("name", sorted(FIXTURES))
def test_fixture_contract_codes_equal_reference(name):
    ref_cls, pt_cls, want = FIXTURES[name]
    ref_v = ref_an.check_fold_contract(ref_cls())
    pt_v = pt_an.check_fold_contract(pt_cls(), name=name)
    assert codes(pt_v) == codes(ref_v) == want
    assert all(v.passname == "contracts" and v.where == name for v in pt_v)
    if name == "EpochDtypeDrift":
        [drift] = pt_v
        assert "int32" in drift.message and "float32" in drift.message
        assert "incremental==recompute" in drift.message
    if name == "OrderSensitiveFloat":
        assert (pt_an.classify_determinism(pt_cls())[0]
                == ref_an.classify_determinism(ref_cls())[0]
                == pt_an.ORDER_SENSITIVE)


@pytest.fixture(scope="module")
def builtins():
    return {"ref": dict(ref_an.builtin_surveys()),
            "pt": dict(pt_an.builtin_surveys())}


@pytest.mark.parametrize("name", BUILTINS)
def test_builtin_contracts_equal_reference(builtins, name):
    """Each built-in: no contract violation and a bitwise verdict in both
    packages."""
    for pkg in ("ref", "pt"):
        an, s = PKG[pkg][0], builtins[pkg][name]
        assert an.check_fold_contract(s, name=name) == [], (pkg, name)
        assert an.classify_determinism(s)[0] == an.BITWISE, (pkg, name)


def test_fold_that_coerces_is_not_traceable_in_both():
    """A fold that coerces a tensor to a Python number fails the
    reference's trace; the port runs it under the determinism scan, which
    refuses the coercion: fold-not-traceable in both."""
    class Ref(EpochDtypeDrift):
        def update(self, state, tri):
            return state + int(tri.valid.sum())

    class Pt(PtEpochDtypeDrift):
        def update(self, state, tri):
            return state + int(tri.valid.sum())

    assert (codes(pt_an.check_fold_contract(Pt()))
            == codes(ref_an.check_fold_contract(Ref()))
            == {"fold-not-traceable"})
    assert pt_an.VERDICTS == ref_an.VERDICTS


# ---------------------------------------------------------------------------
# conservation: exchanges


RAGGED_CAPS = np.array([[0, 3, 1], [2, 0, 0], [4, 1, 2]])


def _exchange(pkg, kind):
    ex = PKG[pkg][1]
    if kind == "dense":
        return ex.DenseExchange(3, 5)
    if kind == "ragged":
        return ex.RaggedExchange(RAGGED_CAPS)
    return ex.make_exchange("mesh", 3, 0, RAGGED_CAPS)


@pytest.mark.parametrize("kind", ["dense", "ragged", "mesh"])
def test_exchange_maps_prove_clean_in_both(kind):
    for pkg in ("ref", "pt"):
        x = _exchange(pkg, kind)
        assert PKG[pkg][0].check_exchange(x) == [], pkg
        if kind == "mesh":
            assert PKG[pkg][0].check_schedule(x.schedule, x.caps) == [], pkg


def _aliased(ex):
    x = ex.RaggedExchange(np.array([[2, 2], [1, 3]]))
    x.block_off = x.block_off.copy()
    x.block_off[0, 1] = x.block_off[0, 0]        # two dest blocks collide
    return x


def _recv_ok_missing(ex):
    x = ex.RaggedExchange(np.array([[2, 2], [1, 3]]))
    x.recv_ok = x.recv_ok.copy()
    x.recv_ok[0, 0] = False                       # a fed slot masked out
    return x


def _recv_ok_phantom(ex):
    x = ex.RaggedExchange(np.array([[2, 0], [1, 1]]))
    x.recv_ok = x.recv_ok.copy()
    x.recv_ok[1, :] = True                        # padding claimed valid
    return x


def _cap_breach(ex):
    x = ex.DenseExchange(2, 4)
    x.caps = x.caps.copy()
    x.caps[0, 1] += 1                             # caps != the send map
    return x


BREAKAGES = {"aliased-send-offsets": _aliased,
             "recv-ok-missing": _recv_ok_missing,
             "recv-ok-phantom": _recv_ok_phantom,
             "send-cap-conservation": _cap_breach}


@pytest.mark.parametrize("code", sorted(BREAKAGES))
def test_seeded_exchange_breakage_codes_equal_reference(code):
    got = {pkg: codes(PKG[pkg][0].check_exchange(BREAKAGES[code](PKG[pkg][1]),
                                                 "push"))
           for pkg in ("ref", "pt")}
    assert got["pt"] == got["ref"] and code in got["pt"]


# ---------------------------------------------------------------------------
# conservation: plans


def labeled_graph(pkg, n=80, m=500, seed=9):
    """tests/test_analysis.py's labelled graph, in either package."""
    csr, gen = PKG[pkg][4], PKG[pkg][5]
    g = gen.temporal_social(n, m, seed=seed)
    spec = csr.MetaSpec(v_int=g.spec.v_int + ("degree",), v_float=(),
                        e_int=("elabel",), e_float=g.spec.e_float)
    deg = g.degrees().astype(np.int32)
    vmeta_i = np.concatenate([g.vmeta_i, deg[:, None]], 1)
    elab = (np.arange(g.m, dtype=np.int32) % 7)[:, None]
    return csr.HostGraph(g.n, g.src, g.dst, spec, vmeta_i, None, elab,
                         g.emeta_f)


@pytest.fixture(scope="module")
def graphs():
    return {pkg: labeled_graph(pkg) for pkg in PKG}


def _plan(graphs, pkg, S=4, survey="TriangleCount", **kw):
    sv = PKG[pkg][3]
    return PKG[pkg][2].plan_engine(graphs[pkg], S, getattr(sv, survey)(),
                                   push_cap=64, **kw)


def _theta(g):
    return max(1, int(np.partition(g.degrees(), -6)[-6]))


@pytest.mark.parametrize("transport", ["dense", "ragged", "mesh"])
def test_plans_reconcile_in_both(graphs, transport):
    """Push-pull and push-only plans, without and with the hub lane, exact
    and bucketed: no violation in either package."""
    theta = _theta(graphs["pt"])
    for pkg in ("ref", "pt"):
        for mode in ("pushpull", "push"):
            for hub in (0, theta):
                for pol in ("exact", "bucket"):
                    cfg, rep = _plan(graphs, pkg, mode=mode, hub_theta=hub,
                                     transport=transport, cap_policy=pol)
                    assert PKG[pkg][0].check_plan(cfg, rep) == [], (
                        pkg, mode, hub, pol)


def test_hand_edited_plans_give_the_reference_codes(graphs):
    """A truncated superstep count, a tampered width and a bucketed plan
    knocked off the grid: the same codes in both packages."""
    got = {}
    for pkg in ("ref", "pt"):
        an = PKG[pkg][0]
        cfg, rep = _plan(graphs, pkg, S=2, mode="pushpull")
        trunc = dataclasses.replace(
            cfg, n_push_steps=max(1, cfg.n_push_steps // 2 - 1))
        wide = dataclasses.replace(
            cfg, meta_widths=(cfg.meta_widths[0] + 1, *cfg.meta_widths[1:]))
        cfg_b, rep_b = _plan(graphs, pkg, S=2, mode="pushpull",
                             transport="ragged", cap_policy="bucket")
        off = dataclasses.replace(cfg_b, pull_row_cap=cfg_b.pull_row_cap + 1)
        got[pkg] = [codes(an.check_plan(c, r))
                    for c, r in ((trunc, rep), (wide, rep), (off, rep_b))]
        trunc_v = [v for v in an.check_plan(trunc, rep)
                   if v.code == "plan-truncation-push"]
        assert trunc_v and "truncated at runtime" in trunc_v[0].message
    assert got["pt"] == got["ref"]
    assert "plan-truncation-push" in got["pt"][0]
    assert "width-mismatch" in got["pt"][1]
    assert "bucket-off-grid" in got["pt"][2]


def test_delta_plans_reconcile_in_both(graphs):
    for pkg in ("ref", "pt"):
        g = graphs[pkg]
        order = np.argsort(g.emeta_f[:, 0], kind="stable")
        k = len(order) // 2
        base = PKG[pkg][4].HostGraph(
            g.n, g.src[order[:k]], g.dst[order[:k]], g.spec, g.vmeta_i,
            g.vmeta_f, g.emeta_i[order[:k]], g.emeta_f[order[:k]])
        dg = base.append_edges(g.src[order[k:]], g.dst[order[k:]],
                               emeta_i=g.emeta_i[order[k:]],
                               emeta_f=g.emeta_f[order[k:]])
        for transport in ("dense", "ragged", "mesh"):
            for pol in ("exact", "bucket"):
                cfg, rep = PKG[pkg][2].plan_delta(
                    dg, 2, PKG[pkg][3].TriangleCount(), transport=transport,
                    cap_policy=pol)
                assert PKG[pkg][0].check_plan(cfg, rep) == [], (
                    pkg, transport, pol)


# ---------------------------------------------------------------------------
# CLI


def test_cli_green(capsys):
    from repro_torch.analysis.__main__ import main
    assert main([]) == 0
    out = capsys.readouterr().out
    assert "contracts: 9 surveys checked, 0 violation(s)" in out
    assert "plans: 9 surveys" in out and "lint: repro_torch swept, 0" in out
    assert "OK: no violations" in out

