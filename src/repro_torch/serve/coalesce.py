"""Multi-tenant request coalescing: one traversal, many tenants.

TriPoll's amortization argument (paper Sec. 4.5) is that the survey
callback is arbitrary — so a tuple of callbacks is just another callback.
:func:`coalesce` applies that to serving: N tenants' surveys against the
same graph epoch are merged into one
:class:`~repro_torch.core.surveys.SurveyBundle` whose members are named
by tenant, the engine runs ONE superstep scan, and :func:`extract`
splits the bundle's ``{name: result}`` finalize back into per-tenant
answers.

Each member folds its own state from the identical triangle batches the
solo run would see, so per-tenant answers are bitwise-identical to running
alone (asserted in tests/test_torch_serve.py).
The only caveat is ``order_sensitive`` surveys whose *stats* may differ in
fold order — :func:`warn_if_order_sensitive` flags those.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass
from typing import Any, Sequence

from repro_torch.core.surveys import Survey, SurveyBundle


@dataclass(frozen=True)
class TenantRequest:
    """One tenant's question: an opaque tenant id plus a Survey instance."""

    tenant: str
    survey: Survey


def coalesce(requests: Sequence[TenantRequest]) -> SurveyBundle:
    """Merge same-epoch tenant requests into one bundle traversal.

    Member names are the tenant ids, so ``finalize`` yields
    ``{tenant: answer}`` directly. Tenant ids must be unique — two
    requests from the same tenant should themselves be bundled by the
    caller (a bundle is a Survey like any other).
    """
    if not requests:
        raise ValueError("coalesce() needs at least one request")
    tenants = [r.tenant for r in requests]
    if len(set(tenants)) != len(tenants):
        raise ValueError(f"duplicate tenant ids: {tenants}")
    return SurveyBundle([r.survey for r in requests], names=tenants)


def extract(result: dict, stats: dict,
            requests: Sequence[TenantRequest]) -> dict:
    """Split a coalesced bundle answer into per-tenant (result, stats).

    ``result`` is the bundle finalize output ``{tenant: answer}``;
    ``stats`` is the shared traversal stats dict. Each tenant gets its own
    answer plus a stats copy annotated with the coalescing width, so a
    tenant can tell (and audit) that its answer came from a shared
    traversal.
    """
    out = {}
    for req in requests:
        if req.tenant not in result:
            raise KeyError(f"no answer for tenant {req.tenant!r} in {list(result)}")
        tenant_stats = dict(stats)
        tenant_stats["coalesced"] = len(requests)
        tenant_stats["tenant"] = req.tenant
        out[req.tenant] = (result[req.tenant], tenant_stats)
    return out


def warn_if_order_sensitive(cfg: Any, requests: Sequence[TenantRequest]) -> None:
    """Coalescing preserves bitwise identity only for ``bitwise`` folds.

    ``order_sensitive`` members (float accumulation orders differ between
    programs) still get *valid* answers, but the coalesced float bits may
    differ from solo — surface that instead of silently degrading the
    warm == cold == solo contract.
    """
    if getattr(cfg, "determinism", "bitwise") == "order_sensitive":
        warnings.warn(
            "coalescing %d tenants with an order_sensitive survey bundle: "
            "answers are correct but float bits may differ from solo runs"
            % len(requests), stacklevel=3)
