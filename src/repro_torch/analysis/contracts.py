"""Fold contracts of a survey (pass 1 of ``repro_torch.analysis``): its
determinism verdict and its fold algebra, found by running its folds.

The JAX package traces a survey's ``update``, ``merge`` and
``merge_epochs`` (``repro.analysis.contracts``): to jaxprs, whose
primitives give the determinism verdict, and by ``jax.eval_shape``, whose
output structures, shapes and dtypes prove the fold algebra. The port
runs the same hooks once on small zero-filled CPU tensors.

:func:`classify_determinism` runs them under a :class:`TorchDispatchMode`
and reads the ATen operators they dispatch:

* a float scatter-add: ``index_add``, ``scatter_add``, ``scatter_reduce``
  with ``sum`` or ``mean``, ``scatter`` with ``reduce="add"``,
  ``index_reduce`` with ``mean``, ``segment_reduce`` with ``sum`` or
  ``mean``, or ``index_put`` / ``put`` with ``accumulate=True``, into a
  floating accumulator; ``bincount`` with floating weights (the
  reference's ``jnp.bincount(weights=...)`` and ``segment_sum`` are
  scatter-adds there);
* an RNG operator (``rand*``, ``normal``, ``uniform_``, ``bernoulli``,
  ``multinomial``, ``exponential_``, ...).

Either stamps :data:`ORDER_SENSITIVE`, with the reasons worded as the
reference words them. A fold that raises, that coerces a tensor to a
Python number (``aten._local_scalar_dense``: ``.item()``, ``int()``,
``bool()``) or whose shapes depend on its data (an operator tagged
``dynamic_output_shape``: ``nonzero``, ``masked_select``, ``unique``,
...; ``index`` or ``index_put`` with a boolean or uint8 index) is
:data:`UNKNOWN`: the counterparts of the reference's "not abstractly
traceable". Integer gathers stay legal, and so does ``bincount``, whose
twin there takes a static ``length``. Float ``amax`` / ``amin``
reductions and sorts are not flagged, as the reference does not flag
them.

:func:`check_fold_contract` proves the algebra with the reference's
checks and codes: ``update`` keeps the state's structure, shapes and
dtypes (a scan carry there), ``merge`` of the state stacked S times keeps
its structure and dtypes, and ``merge_epochs`` is closed over the merged
state. The structures compared are the port's states: a tensor, or
dicts, tuples and lists of states.

Eager execution accepts what a tracer refuses, so the scan refuses it
as ``jax.eval_shape`` does: a coercion of a tensor to a Python number
and an operator with a data-dependent output shape raise in both
(``fold-not-traceable``). The built-ins fold their valid lanes through
``TriangleBatch.valid_index`` (a ``nonzero``); the check's batch is all
valid lanes, and its index is computed before the scan is entered, so
only a fold's own dynamic shapes are refused. Nothing runs on a GPU.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.analysis.report import Violation
from repro_torch.core.surveys import MetaSpec, Survey, TriangleBatch, tree_map

# determinism verdicts (stamped into EngineConfig.determinism)
BITWISE = "bitwise"                  # fold algebra is reduction-order-free
ORDER_SENSITIVE = "order_sensitive"  # result depends on fold/reduction order
UNKNOWN = "unknown"                  # fold could not be traced

VERDICTS = (BITWISE, ORDER_SENSITIVE, UNKNOWN)

# storage widths (dvi, dvf, dei, def_) used when no graph schema is given;
# wide enough for every built-in survey's default lane declarations
DEFAULT_WIDTHS = (2, 2, 2, 2)

# operators (base names, in-place "_" stripped) that scatter-add
_SCATTER_ADD = {"index_add", "scatter_add"}
_ACCUMULATING = {"index_put", "_index_put_impl", "put"}
_RNG = {"normal", "uniform", "bernoulli", "multinomial", "exponential",
        "cauchy", "geometric", "log_normal", "poisson", "native_dropout"}


class _HostCoercion(RuntimeError):
    pass


class _DynamicShape(RuntimeError):
    pass


# tagged dynamic_output_shape but traceable in the reference: its twin,
# jnp.bincount(length=...), has a static shape
_STATIC_TWIN = {"bincount"}
# refused only with a boolean (or uint8) index: a gather's shape, and the
# positions a masked assignment writes, then depend on the data
_MASKABLE = {"index", "index_put", "_index_put_impl"}


def _dynamic_shape(func, name: str, args) -> bool:
    """Whether ``func`` on ``args`` depends on the data for a shape the
    reference's trace must know: an operator tagged
    ``dynamic_output_shape``, where ``index`` (and ``index_put``, which
    the reference refuses alike) counts only with a boolean or uint8
    index; an integer gather's shape is its index's."""
    if name in _MASKABLE:
        idx = args[1] if len(args) > 1 else ()
        return any(isinstance(i, torch.Tensor)
                   and i.dtype in (torch.bool, torch.uint8) for i in idx)
    return (torch.Tag.dynamic_output_shape in func.tags
            and name not in _STATIC_TWIN)


def _valid_batch(spec: MetaSpec, batch: int) -> TriangleBatch:
    """The check's batch: ``batch`` valid zero lanes on the CPU, with its
    valid-lane index computed here, outside the scan."""
    tri = TriangleBatch.zeros(spec, batch, torch.device("cpu"))
    _ = tri.valid_index   # a cached property: its nonzero runs here, once
    return tri


def _arg(args, kwargs, i: int, name: str, default=None):
    return args[i] if len(args) > i else kwargs.get(name, default)


def _float_accumulator(base: str, args, kwargs):
    """The floating accumulator (the first argument; ``bincount``'s
    weights) where the operator ``base`` on these arguments scatter-adds
    into one, else None."""
    acc = args[0] if args else None
    if base in _SCATTER_ADD:
        pass
    elif base == "scatter_reduce":
        if _arg(args, kwargs, 4, "reduce") not in ("sum", "mean"):
            return None
    elif base == "scatter":
        if _arg(args, kwargs, 4, "reduce") != "add":
            return None
    elif base == "index_reduce":
        if _arg(args, kwargs, 4, "reduce") != "mean":
            return None
    elif base == "segment_reduce":
        if _arg(args, kwargs, 1, "reduce") not in ("sum", "mean"):
            return None
    elif base == "bincount":
        acc = _arg(args, kwargs, 1, "weights")
    elif base in _ACCUMULATING:
        if not _arg(args, kwargs, 3, "accumulate", False):
            return None
    else:
        return None
    floating = isinstance(acc, torch.Tensor) and acc.dtype.is_floating_point
    return acc if floating else None


class _FoldScan(TorchDispatchMode):
    """Records the bitwise-contract breakers among the operators a fold
    hook dispatches; raises on a host coercion and on a data-dependent
    output shape."""

    def __init__(self, reasons: list[str]):
        super().__init__()
        self.reasons = reasons
        self.hook = ""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        base = name.removesuffix("_")
        if name == "_local_scalar_dense":
            raise _HostCoercion(
                "aten._local_scalar_dense: .item(), int(), float() or "
                "bool() of a tensor")
        if _dynamic_shape(func, name, args):
            raise _DynamicShape(
                f"aten.{name}: a shape that depends on the data")
        acc = _float_accumulator(base, args, kwargs)
        if acc is not None:
            self.reasons.append(
                f"{self.hook}: float scatter-add "
                f"({str(acc.dtype).removeprefix('torch.')} accumulator)"
                " — the reduction order over colliding indices is "
                "backend-defined, so results are not bitwise across "
                "transports/epochs; accumulate into integer limbs "
                "(counter64, CountingSet) or bucket first")
        elif base.startswith("rand") or base in _RNG:
            self.reasons.append(
                f"{self.hook}: RNG ({name}) in the fold hot path — a "
                "stochastic fold can never satisfy the bitwise "
                "incremental==recompute contract; sample host-side "
                "(DOULION-style) before planning")
        return func(*args, **kwargs)


def _resolve(survey, widths) -> MetaSpec:
    spec = survey if isinstance(survey, MetaSpec) else \
        getattr(survey, "meta_spec", MetaSpec.full())
    return spec.resolve(*widths)


def classify_determinism(survey: Survey, widths=DEFAULT_WIDTHS, S: int = 4,
                         batch: int = 64) -> tuple[str, list[str]]:
    """Classify a survey's fold algebra: :data:`BITWISE`,
    :data:`ORDER_SENSITIVE` (flagged operators in a fold hook, with the
    reasons returned) or :data:`UNKNOWN` (a hook raised, or coerced a
    tensor to a Python number, or gave a shape that depends on the data).
    Runs ``update`` on a zero-filled batch of ``batch`` valid lanes at the
    spec's widths, ``merge`` on the updated state stacked ``S`` times,
    then ``merge_epochs(merged, merged)``, all on the CPU."""
    reasons: list[str] = []
    scan = _FoldScan(reasons)
    try:
        cpu = torch.device("cpu")
        tri = _valid_batch(_resolve(survey, widths), batch)
        state = survey.init(cpu)
        with scan:
            scan.hook = "update"
            state = survey.update(state, tri)
        stacked = tree_map(lambda v: torch.stack([v] * S), state)
        with scan:
            scan.hook = "merge"
            merged = survey.merge(stacked)
            scan.hook = "merge_epochs"
            survey.merge_epochs(merged, merged)
    except Exception as e:  # noqa: BLE001 — a fold that fails IS the finding
        return UNKNOWN, [
            f"fold is not abstractly traceable ({type(e).__name__}: {e}) — "
            "data-dependent shapes or Python int()/float()/bool() coercion "
            "of traced values in a fold hook"]
    return (ORDER_SENSITIVE if reasons else BITWISE), reasons


# ---------------------------------------------------------------------------
# fold algebra


def _tree_sig(tree):
    """(structure, [(shape, dtype) per leaf], [path per leaf]) of a state:
    the structure a nested tuple of ``dict`` (sorted keys), ``tuple`` and
    ``list`` nodes over ``*`` leaves, as a JAX treedef reads."""
    sigs, paths = [], []

    def walk(x, path):
        if isinstance(x, dict):
            return ("dict", tuple((k, walk(x[k], f"{path}[{k!r}]"))
                                  for k in sorted(x)))
        if isinstance(x, (tuple, list)):
            return (type(x).__name__,
                    tuple(walk(y, f"{path}[{i}]") for i, y in enumerate(x)))
        if x is None:
            return ("None", ())
        if isinstance(x, torch.Tensor):
            sigs.append((tuple(x.shape), x.dtype))
        else:
            sigs.append(((), type(x).__name__))
        paths.append(path or "<root>")
        return "*"

    return walk(tree, ""), sigs, paths


def _show(node) -> str:
    """A structure from :func:`_tree_sig` as text (``{'n': *}``, ``(*,)``)."""
    if node == "*":
        return "*"
    kind, kids = node
    if kind == "dict":
        return "{" + ", ".join(f"{k!r}: {_show(c)}" for k, c in kids) + "}"
    if kind == "None":
        return "None"
    inner = ", ".join(_show(c) for c in kids)
    if kind == "tuple":
        return f"({inner},)" if len(kids) == 1 else f"({inner})"
    return f"[{inner}]"


def _dt(dtype) -> str:
    return str(dtype).removeprefix("torch.")


def check_fold_contract(survey: Survey, widths=DEFAULT_WIDTHS, S: int = 4,
                        batch: int = 64,
                        name: str | None = None) -> list[Violation]:
    """Verify the epoch-merge algebra of one survey by running its hooks on
    zero-filled CPU tensors: ``update`` on a batch of ``batch`` valid
    lanes, ``merge`` on ``init()``'s state stacked ``S`` times,
    ``merge_epochs(merged, merged)``, then ``merge_epochs`` once more on
    its own output. The hooks run under the determinism scan's dispatch
    mode, so a coercion of a tensor to a Python number and a
    data-dependent output shape raise (as they fail the reference's
    trace).

    Checks (each yields an actionable :class:`Violation` on failure; the
    codes are the JAX package's):

    * ``fold-carry-*`` — ``update`` keeps the state (structure, shape,
      dtype all preserved);
    * ``merge-*`` — ``merge(stacked)`` keeps ``init()``'s structure and
      dtypes (shapes may change: concat-style merges are legal);
    * ``epoch-merge-*`` — ``merge_epochs(prev, delta)`` is closed over the
      merged-state algebra (structure + dtypes stable under accumulation),
      so K epochs feed back without drift.
    """
    who = name or type(survey).__name__
    v: list[Violation] = []
    cpu = torch.device("cpu")
    scan = _FoldScan([])

    def bad(code: str, msg: str) -> None:
        v.append(Violation("contracts", code, who, msg))

    try:
        spec = _resolve(survey, widths)
    except Exception as e:
        bad("meta-spec-unresolvable",
            f"meta_spec does not resolve against storage widths {widths}: "
            f"{e}")
        return v
    try:
        state = survey.init(cpu)
        s_def, s_sig, paths = _tree_sig(state)
    except Exception as e:
        bad("init-not-traceable",
            f"init() is not abstractly traceable: {type(e).__name__}: {e}")
        return v

    # --- update: the state is carried from batch to batch ---
    try:
        tri = _valid_batch(spec, batch)
        with scan:
            out = survey.update(tree_map(torch.clone, state), tri)
        o_def, o_sig, _ = _tree_sig(out)
        if o_def != s_def:
            bad("fold-carry-structure",
                f"update() returns pytree structure {_show(o_def)} but the "
                f"state is {_show(s_def)}; the fold is scanned, so the carry "
                "structure must be preserved")
        else:
            for p, (ss, sd), (os_, od) in zip(paths, s_sig, o_sig):
                if od != sd:
                    bad("fold-carry-dtype-drift",
                        f"update() drifts state leaf {p} from {_dt(sd)} to "
                        f"{_dt(od)}; a scan carry must keep its dtype — cast "
                        "back explicitly inside update()")
                elif os_ != ss:
                    bad("fold-carry-shape-drift",
                        f"update() drifts state leaf {p} from shape {ss} to "
                        f"{os_}; a scan carry must keep static shapes — use "
                        "fixed-capacity buffers")
    except Exception as e:
        bad("fold-not-traceable",
            f"update() is not abstractly traceable: {type(e).__name__}: {e} "
            "— data-dependent shapes or Python coercion of traced values")
        return v

    # --- merge: cross-shard reduce keeps the state algebra ---
    try:
        with scan:
            merged = survey.merge(tree_map(lambda x: torch.stack([x] * S),
                                           state))
        m_def, m_sig, m_paths = _tree_sig(merged)
        if m_def != s_def:
            bad("merge-structure",
                f"merge(stacked) returns pytree structure {_show(m_def)} but "
                f"init() builds {_show(s_def)}; finalize/merge_epochs consume "
                "the merged state, so the structure must be preserved")
        else:
            for p, (_, sd), (_, md) in zip(paths, s_sig, m_sig):
                if md != sd:
                    bad("merge-dtype-drift",
                        f"merge(stacked) drifts state leaf {p} from {_dt(sd)} "
                        f"to {_dt(md)}; cross-shard reduction must not "
                        "promote — cast back explicitly (watch sum "
                        "promotions: pass dtype= to .sum())")
    except Exception as e:
        bad("merge-not-traceable",
            f"merge() is not abstractly traceable: {type(e).__name__}: {e}")
        return v

    # --- merge_epochs: closed over the merged-state algebra ---
    try:
        with scan:
            acc = survey.merge_epochs(merged, merged)
        a_def, a_sig, _ = _tree_sig(acc)
        if a_def != m_def:
            bad("epoch-merge-structure",
                f"merge_epochs(prev, delta) returns pytree structure "
                f"{_show(a_def)} but merged state is {_show(m_def)}; the "
                "accumulator feeds back as prev_state, so the structure must "
                "be closed")
        else:
            for p, (_, md), (_, ad) in zip(m_paths, m_sig, a_sig):
                if ad != md:
                    bad("epoch-merge-dtype-drift",
                        f"merge_epochs drifts state leaf {p} from {_dt(md)} "
                        f"to {_dt(ad)}; after one epoch the accumulator no "
                        "longer matches a one-shot run's dtype — the bitwise "
                        "incremental==recompute identity is broken. Cast "
                        "back explicitly in merge_epochs")
            # closure: the accumulator must feed back as prev for epoch K+1
            with scan:
                survey.merge_epochs(acc, merged)
    except Exception as e:
        bad("epoch-merge-not-closed",
            f"merge_epochs does not accept its own output as prev_state: "
            f"{type(e).__name__}: {e}")
    return v


def builtin_surveys(n: int = 256) -> list[tuple[str, Survey]]:
    """Every built-in survey (plus a representative bundle), instantiated
    small — the matrix the CLI verifies, as the JAX package's."""
    from repro_torch.core.surveys import (ClosureTime, DegreeTriples,
                                          Enumerate, LabelTripleSet,
                                          LocalVertexCount, MaxEdgeLabelDist,
                                          SurveyBundle, TopKWeightedTriangles,
                                          TriangleCount)
    return [
        ("TriangleCount", TriangleCount()),
        ("LocalVertexCount", LocalVertexCount(n)),
        ("ClosureTime", ClosureTime()),
        ("MaxEdgeLabelDist", MaxEdgeLabelDist(n_labels=8)),
        ("DegreeTriples", DegreeTriples(capacity=512)),
        ("LabelTripleSet", LabelTripleSet(capacity=1024)),
        ("Enumerate", Enumerate(capacity=64)),
        ("TopKWeightedTriangles", TopKWeightedTriangles(k=8)),
        ("SurveyBundle", SurveyBundle([TriangleCount(), ClosureTime(),
                                       LabelTripleSet(capacity=512)])),
    ]
