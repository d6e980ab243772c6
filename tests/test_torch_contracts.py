"""The port's fold-determinism stamp against the JAX package's: each survey
is written twice, once for each package, and ``plan_engine`` must stamp the
same verdict on karate with S=2. The reference traces its folds to jaxprs
(``repro.analysis.contracts``); the port runs them under a dispatch mode
(``repro_torch.analysis.contracts``)."""
import jax
import jax.numpy as jnp
import pytest
import torch

from repro.analysis import contracts as ref_ct
from repro.core import pushpull as ref_pp
from repro.core import surveys as ref_sv
from repro.graphs import csr as ref_csr
from repro.graphs import generators as ref_gen
from repro_torch.analysis import contracts as pt_ct
from repro_torch.core import pushpull as pt_pp
from repro_torch.core import surveys as pt_sv
from repro_torch.graphs import csr as pt_csr
from repro_torch.graphs import generators as pt_gen

torch.set_num_threads(1)

SPEC = dict(v_int=("label", "degree"), e_int=("tsbucket",), e_float=("ts",))
FLOAT_ADD = "float scatter-add (float32 accumulator)"


@pytest.fixture(scope="module")
def karate():
    return (ref_gen.karate(ref_csr.MetaSpec(**SPEC)),
            pt_gen.karate(pt_csr.MetaSpec(**SPEC)))


def stamps(karate, ref_survey, pt_survey) -> tuple[str, str]:
    return (ref_pp.plan_engine(karate[0], 2, ref_survey)[0].determinism,
            pt_pp.plan_engine(karate[1], 2, pt_survey)[0].determinism)


# ---------------------------------------------------------------------------
# user surveys, each in both packages: an [8] float32 table indexed by p


class RefTable(ref_sv.Survey):
    meta_spec = ref_sv.MetaSpec.none()

    def init(self):
        return jnp.zeros(8, jnp.float32)


class PtTable(pt_sv.Survey):
    meta_spec = pt_sv.MetaSpec.none()

    def init(self, device):
        return torch.zeros(8, dtype=torch.float32, device=device)


class RefFloatAdd(RefTable):
    def update(self, st, tri):
        return st.at[tri.p % 8].add(tri.valid.astype(jnp.float32))


class PtFloatAdd(PtTable):
    def update(self, st, tri):
        return st.index_add(0, (tri.p % 8).long(), tri.valid.float())


class RefRandom(RefTable):
    def update(self, st, tri):
        return st + jax.random.uniform(jax.random.PRNGKey(0), (8,))


class PtRandom(PtTable):
    def update(self, st, tri):
        return st + torch.rand(8, generator=torch.Generator().manual_seed(0))


class RefCoerce(RefTable):
    def __init__(self, how):
        self.how = how

    def update(self, st, tri):
        n = tri.valid.sum()
        return st + (int(n) if self.how == "int" else n.item())


class PtCoerce(PtTable):
    def __init__(self, how):
        self.how = how

    def update(self, st, tri):
        n = tri.valid.sum()
        return st + (int(n) if self.how == "int" else n.item())


# the port's other spellings of a float scatter-add, and of a float max and
# a sort (neither flagged), each against its twin in the reference
def _index(tri):
    return (tri.p % 8).long()


def _segments(tri):
    return torch.tensor([tri.p.shape[0]])   # the whole batch, one segment


PT_FOLDS = {
    "index_add_": lambda st, tri: st.clone().index_add_(0, _index(tri),
                                                         tri.valid.float()),
    "scatter_add": lambda st, tri: st.scatter_add(0, _index(tri),
                                                  tri.valid.float()),
    "scatter_reduce_sum": lambda st, tri: st.scatter_reduce(
        0, _index(tri), tri.valid.float(), "sum"),
    "scatter_reduce_mean": lambda st, tri: st.scatter_reduce(
        0, _index(tri), tri.valid.float(), "mean"),
    "index_reduce_mean": lambda st, tri: st.index_reduce(
        0, _index(tri), tri.valid.float(), "mean"),
    "index_put_accumulate": lambda st, tri: st.index_put(
        (_index(tri),), tri.valid.float(), accumulate=True),
    "put_accumulate": lambda st, tri: st.put(_index(tri), tri.valid.float(),
                                             accumulate=True),
    "bincount_weights": lambda st, tri: st + torch.bincount(
        _index(tri), weights=tri.valid.float(), minlength=8),
    "segment_reduce_sum": lambda st, tri: st + torch.segment_reduce(
        tri.valid.float(), "sum", lengths=_segments(tri)),
    "segment_reduce_mean": lambda st, tri: st + torch.segment_reduce(
        tri.valid.float(), "mean", lengths=_segments(tri)),
    "scatter_reduce_amax": lambda st, tri: st.scatter_reduce(
        0, _index(tri), tri.valid.float(), "amax"),
    "sort": lambda st, tri: torch.sort(st + tri.valid[:8].float())[0],
}
REF_FOLDS = {
    "add": lambda st, tri: st.at[tri.p % 8].add(tri.valid.astype(jnp.float32)),
    "bincount": lambda st, tri: st + jnp.bincount(
        tri.p % 8, weights=tri.valid.astype(jnp.float32), length=8),
    "segment_sum": lambda st, tri: st + jax.ops.segment_sum(
        tri.valid.astype(jnp.float32), tri.p * 0, num_segments=1),
    "max": lambda st, tri: st.at[tri.p % 8].max(tri.valid.astype(jnp.float32)),
    "sort": lambda st, tri: jnp.sort(st + tri.valid[:8].astype(jnp.float32)),
}
TWIN = {"bincount_weights": "bincount", "segment_reduce_sum": "segment_sum",
        "segment_reduce_mean": "segment_sum", "scatter_reduce_amax": "max",
        "sort": "sort"}
NOT_FLAGGED = ("scatter_reduce_amax", "sort")


def _with_update(base, fold, name="Custom"):
    return type(name, (base,), {"update": lambda self, st, tri: fold(st, tri)})()


# ---------------------------------------------------------------------------


def test_float_scatter_add_is_order_sensitive(karate):
    assert stamps(karate, RefFloatAdd(), PtFloatAdd()) == \
        ("order_sensitive", "order_sensitive")
    ref = ref_ct.classify_determinism(RefFloatAdd())
    port = pt_ct.classify_determinism(PtFloatAdd())
    assert port == ref and FLOAT_ADD in port[1][0]


@pytest.mark.parametrize("fold", sorted(PT_FOLDS))
def test_scatter_spellings_follow_reference(karate, fold):
    """Every float scatter-add spelling is flagged (bincount with float
    weights and segment sums too, as the reference flags its scatter-add
    twins); a float scatter-max and a sort are not, as the reference flags
    neither."""
    ref = _with_update(RefTable, REF_FOLDS[TWIN.get(fold, "add")])
    port = _with_update(PtTable, PT_FOLDS[fold])
    want = "bitwise" if fold in NOT_FLAGGED else "order_sensitive"
    assert stamps(karate, ref, port) == (want, want)


def test_rng_in_update_is_order_sensitive(karate):
    assert stamps(karate, RefRandom(), PtRandom()) == \
        ("order_sensitive", "order_sensitive")
    verdict, reasons = pt_ct.classify_determinism(PtRandom())
    assert verdict == "order_sensitive" and "update: RNG (rand)" in reasons[0]


def test_verdict_follows_the_fold_not_the_class_name(karate):
    """A subclass of a built-in is traced bitwise; a user class that
    reuses a built-in's name but scatter-adds floats is not."""
    ref_sub = type("Sub", (ref_sv.TriangleCount,), {})()
    pt_sub = type("Sub", (pt_sv.TriangleCount,), {})()
    assert stamps(karate, ref_sub, pt_sub) == ("bitwise", "bitwise")
    ref_tc = type("TriangleCount", (RefFloatAdd,), {})()
    pt_tc = type("TriangleCount", (PtFloatAdd,), {})()
    assert stamps(karate, ref_tc, pt_tc) == ("order_sensitive",
                                             "order_sensitive")


@pytest.mark.parametrize("how", ["int", "item"])
def test_host_coercion_in_update_is_unknown(karate, how):
    assert stamps(karate, RefCoerce(how), PtCoerce(how)) == ("unknown",
                                                            "unknown")
    verdict, reasons = pt_ct.classify_determinism(PtCoerce(how))
    assert verdict == "unknown" and "_local_scalar_dense" in reasons[0]


def test_a_fold_that_raises_is_unknown():
    bad = _with_update(PtTable, lambda st, tri: st + tri.p[:3])
    verdict, reasons = pt_ct.classify_determinism(bad)
    assert verdict == "unknown" and "RuntimeError" in reasons[0]


def builtins(m, n):
    return [m.TriangleCount(), m.LocalVertexCount(n), m.ClosureTime(ts_col=0),
            m.MaxEdgeLabelDist(16), m.DegreeTriples(deg_col=1, capacity=4096),
            m.LabelTripleSet(capacity=4096, counting_backend="scatter"),
            m.Enumerate(capacity=64), m.TopKWeightedTriangles(k=8)]


def test_bundle_with_a_float_member_is_order_sensitive(karate):
    ref = ref_sv.SurveyBundle([ref_sv.TriangleCount(), RefFloatAdd()])
    port = pt_sv.SurveyBundle([pt_sv.TriangleCount(), PtFloatAdd()])
    assert stamps(karate, ref, port) == ("order_sensitive", "order_sensitive")


def test_every_builtin_and_their_bundle_are_bitwise(karate):
    n = karate[1].n
    pairs = list(zip(builtins(ref_sv, n), builtins(pt_sv, n)))
    pairs.append((ref_sv.SurveyBundle(builtins(ref_sv, n)),
                  pt_sv.SurveyBundle(builtins(pt_sv, n))))
    for ref, port in pairs:
        assert stamps(karate, ref, port) == ("bitwise", "bitwise"), \
            type(port).__name__


def test_verdict_is_cached_per_survey(karate):
    """A second plan of the same survey does not run its folds again."""
    calls = []

    class Counted(PtFloatAdd):
        def update(self, st, tri):
            calls.append(1)
            return super().update(st, tri)

    survey = Counted()
    for _ in range(2):
        assert pt_pp.plan_engine(karate[1], 2, survey)[0].determinism == \
            "order_sensitive"
    assert len(calls) == 1


# folds whose output shape depends on the data: the reference's trace
# refuses each, and so does the port's scan (ROADMAP Queue 3 (m))
def _plus_sum(ref_select, pt_select):
    """The reference's fold and the port's: the state plus the sum of a
    selection, cast to float32 by a tensor operation (no coercion)."""
    return (lambda st, tri: st + ref_select(tri).sum().astype(jnp.float32),
            lambda st, tri: st + pt_select(tri).sum().float())


# each fold's shape (or the positions it writes) is decided by the data
DYNAMIC_FOLDS = {
    "nonzero": _plus_sum(lambda tri: jnp.nonzero(tri.valid)[0],
                         lambda tri: tri.valid.nonzero()),
    "bool_mask": _plus_sum(lambda tri: tri.p[tri.valid],
                           lambda tri: tri.p[tri.valid]),
    "masked_select": _plus_sum(
        lambda tri: jnp.extract(tri.valid, tri.p),
        lambda tri: torch.masked_select(tri.p, tri.valid)),
    "unique": _plus_sum(lambda tri: jnp.unique(tri.p),
                        lambda tri: torch.unique(tri.p)),
    "bool_mask_assign": (
        lambda st, tri: st.at[tri.valid[:8]].set(1.0),
        lambda st, tri: st.index_put((tri.valid[:8],), torch.tensor(1.0))),
}


@pytest.mark.parametrize("fold", sorted(DYNAMIC_FOLDS))
def test_data_dependent_shape_is_not_traceable_in_both(fold):
    """fold-not-traceable from check_fold_contract and unknown from
    classify_determinism, in both packages."""
    ref_fold, pt_fold = DYNAMIC_FOLDS[fold]
    for ct, survey in ((ref_ct, _with_update(RefTable, ref_fold)),
                       (pt_ct, _with_update(PtTable, pt_fold))):
        codes = [v.code for v in ct.check_fold_contract(survey)]
        assert codes == ["fold-not-traceable"], (ct.__name__, codes)
        assert ct.classify_determinism(survey)[0] == "unknown", ct.__name__


def test_integer_gather_in_a_user_fold_stays_bitwise(karate):
    """An integer-index gather has its index's shape: it passes in both,
    and so does a fold that reads the batch's valid-lane index."""
    ref = _with_update(RefTable, lambda st, tri: st[tri.p[:8] % 8] + 1.0)
    port = _with_update(PtTable,
                        lambda st, tri: st[(tri.p[:8] % 8).long()] + 1.0)
    assert ref_ct.check_fold_contract(ref) == []
    assert pt_ct.check_fold_contract(port) == []
    assert stamps(karate, ref, port) == ("bitwise", "bitwise")
    valid = _with_update(PtTable, lambda st, tri: st.index_put(
        ((tri.p[tri.valid_index] % 8).long(),), torch.tensor(1.0)))
    assert pt_ct.classify_determinism(valid) == ("bitwise", [])
