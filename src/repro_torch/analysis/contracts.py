"""Fold-determinism verdict of a survey, found by tracing its folds.

The JAX package traces a survey's ``update``, ``merge`` and
``merge_epochs`` to jaxprs (``repro.analysis.contracts``) and flags the
primitives that break the bitwise contracts: a float scatter-add (its
reduction order over colliding indices is backend-defined), a host
callback, RNG. The port runs the same three hooks once on small CPU
tensors under a :class:`TorchDispatchMode` and reads the ATen operators
they dispatch:

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
reference words them. A fold that raises, or that coerces a tensor to a
Python number (``aten._local_scalar_dense``: ``.item()``, ``int()``,
``bool()``), is :data:`UNKNOWN`: the counterpart of the reference's "not
abstractly traceable". Float ``amax`` / ``amin`` reductions and sorts are
not flagged, as the reference does not flag them. Nothing runs on a GPU.
"""
from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.core.surveys import MetaSpec, Survey, TriangleBatch, tree_map

# determinism verdicts (stamped into EngineConfig.determinism)
BITWISE = "bitwise"                  # fold algebra is reduction-order-free
ORDER_SENSITIVE = "order_sensitive"  # result depends on fold/reduction order
UNKNOWN = "unknown"                  # fold could not be traced

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
    hook dispatches; raises on a host coercion."""

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
    tensor to a Python number). Runs ``update`` on a zero-filled batch of
    ``batch`` valid lanes at the spec's widths, ``merge`` on the updated
    state stacked ``S`` times, then ``merge_epochs(merged, merged)``, all
    on the CPU."""
    reasons: list[str] = []
    scan = _FoldScan(reasons)
    try:
        cpu = torch.device("cpu")
        tri = TriangleBatch.zeros(_resolve(survey, widths), batch, cpu)
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
