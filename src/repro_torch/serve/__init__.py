"""Long-lived survey serving: plan-cached, multi-tenant, epoch-pipelined.

The one-shot pipeline (``plan_engine`` → ``shard_dodgr`` →
``make_survey_fn`` → traverse) pays planning and sharding on every
request. This package amortizes both, as the JAX package's
``repro.serve`` does:

* :mod:`repro_torch.serve.plan_cache` — content-keyed LRU over (plan,
  shards, survey function) triplets with byte-budget eviction, persisted
  across restarts and packages (:func:`save_plan_cache` /
  :func:`load_plan_cache`);
* :mod:`repro_torch.serve.coalesce` — many tenants' questions against the
  same graph epoch merged into one
  :class:`~repro_torch.core.surveys.SurveyBundle` traversal, with
  per-tenant extraction afterwards;
* :mod:`repro_torch.serve.ingest` — background epoch pipeline:
  ``append_edges`` batches are sharded and delta-surveyed off the query
  path;
* :mod:`repro_torch.serve.service` — :class:`SurveyService`, the
  long-lived front door tying them together, on one device.

Everything served is bitwise the one-shot ``survey_*`` path and the JAX
package's service (warm == cold == solo).
"""
from repro_torch.serve.coalesce import TenantRequest, coalesce, extract
from repro_torch.serve.plan_cache import (CacheEntry, PlanCache, entry_nbytes,
                                          load_plan_cache, save_plan_cache)
from repro_torch.serve.service import (SurveyService,
                                       enable_persistent_compilation_cache)

__all__ = ["CacheEntry", "PlanCache", "SurveyService", "TenantRequest",
           "coalesce", "enable_persistent_compilation_cache", "entry_nbytes",
           "load_plan_cache", "save_plan_cache"]
