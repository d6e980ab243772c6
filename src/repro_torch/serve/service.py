"""``SurveyService`` — the long-lived, plan-cached survey front door.

One instance owns a graph snapshot on one device and amortizes the
one-shot pipeline across requests and epochs:

* **queries** hit the :class:`~repro_torch.serve.plan_cache.PlanCache`
  first — a content-key hit replays the cached (plan, shards, survey
  function) triplet and, for an exact repeat, finalizes the memoized
  warm-up state; a miss plans, shards and warms once and caches it;
* **survey functions** are shared one level deeper, keyed by ``(survey
  fingerprint, cfg with epoch := 0)``: ``cfg.epoch`` and ``gr.epoch`` are
  host bookkeeping, and under the default ``cap_policy="bucket"`` every
  planned capacity is rounded up to the bucket grid, with lifetime
  high-water floors on the delta path, so epochs whose caps merely drift
  run one function on shards of one shape signature. Each call counts a
  new (key, signature) pair as a recompile and a repeat as a hit, as the
  JAX package counts its executables (``jit_cache_*`` in query stats,
  :meth:`SurveyService.ingest_stats` and :class:`Snapshot`);
* **restarts** warm-start: :meth:`SurveyService.checkpoint` persists the
  plan cache next to the epoch state (``.plans.npz``) and
  :meth:`SurveyService.restore` preloads it, so the first query after a
  restart answers from the memoized state without replanning;
  ``compile_cache_dir=`` also keeps the built kernels there;
* **ingestion** rides :class:`~repro_torch.serve.ingest.IngestPipeline`:
  ``append_edges`` batches become delta epochs on a worker thread (hub
  tables from a :class:`~repro_torch.core.dodgr.HubTableCache`, resident
  surveys advanced incrementally) while queries keep answering from the
  last merged snapshot;
* **tenants** coalesce: :meth:`SurveyService.query_coalesced` folds many
  tenants' surveys into one traversal via :mod:`repro_torch.serve.coalesce`.

Every path is bitwise the one-shot ``survey_*`` calls with
``orient="stable"`` (the orientation the service fixes so delta epochs
and hub-table reuse stay exact), and bitwise the JAX package's service.
Shards, memoized states and resident states stay on the service's device.
"""
from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass, replace
from pathlib import Path
from typing import Any, Sequence

import numpy as np

from repro_torch.core import engine
from repro_torch.core.dodgr import (META_FIELDS, PER_SHARD_FIELDS,
                                    REPLICATED_FIELDS, HubTableCache,
                                    shard_delta, shard_dodgr)
from repro_torch.core.engine import (finalize_epochs, make_survey_fn,
                                     survey_with_fn)
from repro_torch.core.pushpull import (delta_token, graph_token,
                                       plan_content_key, plan_delta,
                                       plan_engine, survey_fingerprint)
from repro_torch.core.surveys import Survey, SurveyBundle
from repro_torch.graphs import io as gio
from repro_torch.graphs.csr import DeltaGraph, HostGraph
from repro_torch.kernels import _cuda
from repro_torch.serve.coalesce import (TenantRequest, coalesce, extract,
                                        warn_if_order_sensitive)
from repro_torch.serve.ingest import IngestPipeline
from repro_torch.serve.plan_cache import (CacheEntry, PlanCache, entry_nbytes,
                                          load_plan_cache, save_plan_cache)
from repro_torch.utils import resolve_device


def enable_persistent_compilation_cache(cache_dir) -> bool:
    """Keep the built CUDA kernels in ``cache_dir``: the port's only
    compiled artifacts are the ``nvcc`` libraries (``kernels/_cuda.py``),
    so a restarted service pointed at the same directory loads them from
    disk instead of building them. Returns True."""
    _cuda.BUILD_ROOT = Path(cache_dir)
    return True


def _graph_signature(gr) -> tuple:
    """The static fields of a ``ShardedDODGr`` and each tensor field's
    (shape, dtype): two graphs with equal signatures run one survey
    function on shards of one shape."""
    return (tuple((f, getattr(gr, f)) for f in META_FIELDS),
            tuple((tuple(getattr(gr, f).shape), str(getattr(gr, f).dtype))
                  for f in PER_SHARD_FIELDS + REPLICATED_FIELDS))


def _plans_path(path) -> str:
    """Sidecar plan-cache file next to an epoch-state checkpoint."""
    p = str(path)
    if p.endswith(".npz"):
        p = p[:-4]
    return p + ".plans.npz"


@dataclass(frozen=True)
class Snapshot:
    """One immutable serving epoch: queries and resident answers read a
    single pointer to this, so an ingest swap is atomic."""

    epoch: int
    token: str               # content token of the union as of this epoch
    union: HostGraph
    dg: DeltaGraph | None    # None before the first appended batch
    resident_state: Any      # resident bundle's merged accumulator (or None)
    jit_hits: int = 0        # cumulative function reuses as of this swap
    jit_recompiles: int = 0  # cumulative new (key, signature) pairs


class SurveyService:
    """Serve triangle surveys from a cached, epoch-pipelined graph.

    ``resident`` surveys (``{name: Survey}``) are answered incrementally:
    each ingested batch advances their state through the delta engine and
    :meth:`resident_answers` renders it without a traversal. Ad-hoc
    :meth:`query` surveys run against the current snapshot through the
    plan cache.

    ``device=None`` is the card, and raises without one (as
    :func:`~repro_torch.utils.resolve_device`); pass ``device="cpu"`` for
    the plain path. ``mesh`` is kept for parity: a service over the mesh
    transport (one shard per ``torch.distributed`` rank) is not ported
    and a mesh raises. The service fixes ``orient="stable"``.
    """

    def __init__(self, graph: HostGraph, S: int, *,
                 mode: str = "pushpull",
                 transport: str = "dense",
                 push_cap: int = 256,
                 pull_q_cap: int | None = None,
                 hub_theta: int | str = 0,
                 hub_wedge_cap: int = 256,
                 max_hubs: int = 1024,
                 sample_p: float = 1.0,
                 sample_seed: int = 0,
                 mesh=None,
                 cache_bytes: int | None = None,
                 resident: dict[str, Survey] | None = None,
                 max_pending: int = 64,
                 token: str | None = None,
                 epoch: int = 0,
                 cap_policy: str = "bucket",
                 preload_plans: Sequence[CacheEntry] | None = None,
                 compile_cache_dir=None,
                 device=None):
        if mesh is not None:
            raise NotImplementedError(
                "SurveyService(mesh=) — a service whose surveys run one shard "
                "per torch.distributed rank — is not ported yet; see "
                "ROADMAP.md, Queue 1 item 8")
        self.device = resolve_device(device)
        if sample_p < 1.0 and resident:
            raise ValueError("resident surveys ride the delta engine, which "
                             "rejects DOULION sampling — serve sampled "
                             "questions as ad-hoc queries instead")
        if cap_policy not in ("exact", "bucket"):
            raise ValueError(f"cap_policy must be 'exact' or 'bucket', "
                             f"got {cap_policy!r}")
        if compile_cache_dir is not None:
            enable_persistent_compilation_cache(compile_cache_dir)
        self.S = int(S)
        self.mode = mode
        self.transport = transport
        self.push_cap = push_cap
        self.pull_q_cap = pull_q_cap
        self.hub_theta = hub_theta
        self.hub_wedge_cap = hub_wedge_cap
        self.max_hubs = max_hubs
        self.sample_p = float(sample_p)
        self.sample_seed = int(sample_seed)
        # "bucket" rounds every planned capacity up to the geometric grid
        # (utils.bucket_cap), so epochs whose caps drift inside one bucket
        # share one shape signature; results are bitwise "exact"'s
        self.cap_policy = cap_policy
        self._mesh = mesh
        self.cache = PlanCache(cache_bytes)
        self._jit_cache: dict = {}
        self._jit_lock = threading.Lock()
        self._compiled: set = set()    # (function key, graph signature) seen
        self._jit_hits = 0
        self._jit_recompiles = 0
        self._epochs_applied = 0
        # shape hysteresis over the service's life (delta path, bucket): the
        # last delta config floors the next plan's caps inside the planner
        # (promote_from), and e_cap / d_plus_max keep their high-water
        # marks, so an epoch whose frontier shrank keeps the shapes
        self._shape_hw = None          # last delta EngineConfig
        self._ecap_hw = 0
        self._dmax_hw = 0
        if preload_plans:
            for entry in preload_plans:
                self.cache.insert(entry)

        self._resident = (SurveyBundle(list(resident.values()),
                                       names=list(resident.keys()))
                          if resident else None)
        self._hub_cache = (HubTableCache(graph)
                           if self._resident is not None and
                           (hub_theta == "auto" or int(hub_theta) >= 1)
                           else None)

        tok = token if token is not None else graph_token(graph)
        self._snapshot = Snapshot(epoch=int(epoch), token=tok, union=graph,
                                  dg=None, resident_state=None)
        if self._resident is not None:
            entry, _, _ = self._prepare(self._resident)
            if self.cap_policy == "bucket":
                # a frontier's d₊max never exceeds the union's, so the
                # warm-up shards seed the high-water mark
                self._dmax_hw = entry.gr.d_plus_max
            self._snapshot = replace(self._snapshot,
                                     resident_state=entry.raw[0])
        self._ingest = IngestPipeline(self._apply_batch,
                                      max_pending=max_pending)

    # -- snapshot queries (plan-cached) -----------------------------------

    @property
    def snapshot(self) -> Snapshot:
        return self._snapshot

    @property
    def epoch(self) -> int:
        return self._snapshot.epoch

    def content_key(self, survey: Survey, snap: Snapshot | None = None) -> str:
        snap = snap or self._snapshot
        return plan_content_key(
            snap.token, self.S, survey, mode=self.mode,
            transport=self.transport, hub_theta=self.hub_theta,
            sample_p=self.sample_p, sample_seed=self.sample_seed,
            orient="stable", epoch=snap.epoch, cap_policy=self.cap_policy)

    def _jit_for(self, survey: Survey, cfg) -> Any:
        """The survey function for ``(survey, cfg)``, keyed by the survey's
        fingerprint and ``cfg`` with its epoch set to 0 (the epoch is
        host bookkeeping), so epochs whose bucketed caps agree share one.
        Each call counts its (key, graph signature) pair: a repeat is a
        hit, a new pair a recompile."""
        jkey = (survey_fingerprint(survey), replace(cfg, epoch=0))
        with self._jit_lock:
            fn = self._jit_cache.get(jkey)
        if fn is not None:
            return fn
        run = make_survey_fn(survey, cfg, mesh=self._mesh)

        def fn(gr, _jkey=jkey, _run=run):
            gr0 = replace(gr, epoch=0)
            sig = (_jkey, _graph_signature(gr0))
            with self._jit_lock:
                if sig in self._compiled:
                    self._jit_hits += 1
                else:
                    self._compiled.add(sig)
                    self._jit_recompiles += 1
            return _run(gr0)

        with self._jit_lock:
            self._jit_cache.setdefault(jkey, fn)
            return self._jit_cache[jkey]

    def _prepare(self, survey: Survey,
                 snap: Snapshot | None = None) -> tuple[CacheEntry, bool, float]:
        """Resolve (plan, shards, survey function) for ``survey`` against
        the snapshot — from cache, or built, warmed and cached."""
        snap = snap or self._snapshot
        key = self.content_key(survey, snap)
        t0 = time.perf_counter()
        entry = self.cache.lookup(key)
        if entry is not None:
            if entry.fn is None:
                # restored by load_plan_cache: attach the Survey instance
                # and its function (the memo answers an exact repeat
                # without calling it)
                entry.survey = survey
                entry.fn = self._jit_for(survey, entry.cfg)
            return entry, True, time.perf_counter() - t0
        cfg, report = plan_engine(
            snap.union, self.S, survey, mode=self.mode,
            push_cap=self.push_cap, pull_q_cap=self.pull_q_cap,
            sample_p=self.sample_p, sample_seed=self.sample_seed,
            orient="stable", epoch=snap.epoch, transport=self.transport,
            hub_theta=self.hub_theta, hub_wedge_cap=self.hub_wedge_cap,
            max_hubs=self.max_hubs, cap_policy=self.cap_policy)
        gr, _ = shard_dodgr(
            snap.union, self.S, sample_p=self.sample_p,
            sample_seed=self.sample_seed, orient="stable", epoch=snap.epoch,
            hub_theta=cfg.hub_theta, cap_policy=self.cap_policy,
            device=self.device)
        fn = self._jit_for(survey, cfg)
        raw = fn(gr)   # the warm-up traversal
        entry = self.cache.insert(CacheEntry(
            key=key, survey=survey, cfg=cfg, report=report, gr=gr, fn=fn,
            raw=raw, nbytes=entry_nbytes(gr),
            survey_fp=survey_fingerprint(survey)))
        return entry, False, time.perf_counter() - t0

    def _annotate(self, stats: dict, *, hit: bool, setup_s: float,
                  snap: Snapshot, served_from: str) -> dict:
        stats["plan_cache_hit"] = float(hit)
        stats["plan_setup_s"] = float(setup_s)
        stats["served_epoch"] = float(snap.epoch)
        stats["served_from"] = served_from
        for k, v in self.cache.stats().items():
            if isinstance(v, (int, float)):
                stats[f"plan_cache_{k}"] = float(v)
        with self._jit_lock:
            stats["jit_cache_hits"] = float(self._jit_hits)
            stats["jit_cache_recompiles"] = float(self._jit_recompiles)
            stats["jit_cache_entries"] = float(len(self._compiled))
        return stats

    def _answer(self, survey: Survey, snap: Snapshot, rerun: bool):
        """(entry, result, stats) of one survey against ``snap``: the
        memoized state finalized, or with ``rerun`` (or no memo) a
        traversal; the same bits either way."""
        entry, hit, setup_s = self._prepare(survey, snap)
        if rerun or entry.raw is None:
            result, stats = survey_with_fn(entry.gr, entry.survey,
                                           entry.cfg, entry.fn)
            served_from = "traversal"
        else:
            merged, dstats = entry.raw
            result, stats = engine._finalize_run(entry.survey, entry.cfg,
                                                 merged, dstats)
            served_from = "memo"
        return entry, result, self._annotate(
            stats, hit=hit, setup_s=setup_s, snap=snap,
            served_from=served_from)

    def query(self, survey: Survey, *, rerun: bool = False):
        """Answer one survey against the current snapshot. A plan-cache hit
        replays the cached function; an exact repeat finalizes the
        memoized state instead. ``rerun=True`` forces the traversal; the
        result is bitwise the same either way (warm == cold == solo)."""
        _, result, stats = self._answer(survey, self._snapshot, rerun)
        return result, stats

    def query_coalesced(self, requests: Sequence[TenantRequest], *,
                        rerun: bool = False) -> dict:
        """Answer N tenants' surveys with ONE traversal of the snapshot.
        Returns ``{tenant: (result, stats)}``; each tenant's result is
        bitwise :meth:`query` of its survey alone."""
        entry, result, stats = self._answer(coalesce(requests),
                                            self._snapshot, rerun)
        warn_if_order_sensitive(entry.cfg, requests)
        return extract(result, stats, requests)

    # -- resident surveys (epoch-incremental) -----------------------------

    def resident_answers(self) -> dict:
        """Render the resident surveys' accumulated state: no traversal,
        the ingest pipeline already folded every epoch."""
        snap = self._snapshot
        if self._resident is None or snap.resident_state is None:
            raise ValueError("no resident surveys were registered")
        return finalize_epochs(self._resident, snap.resident_state)

    # -- ingestion (epoch pipeline) ---------------------------------------

    def append_edges(self, src, dst, emeta_i=None, emeta_f=None, n=None,
                     vmeta_i=None, vmeta_f=None, *, wait: bool = False):
        """Enqueue one edge batch for background epoch merge. Queries keep
        answering from the last merged snapshot until the swap; pass
        ``wait=True`` (or call :meth:`flush`) to block until merged."""
        self._ingest.submit(dict(src=np.asarray(src), dst=np.asarray(dst),
                                 emeta_i=emeta_i, emeta_f=emeta_f, n=n,
                                 vmeta_i=vmeta_i, vmeta_f=vmeta_f))
        if wait:
            self.flush()

    def _apply_batch(self, batch: dict) -> None:
        """Worker-thread epoch merge: advance the delta graph and token
        chain, fold the residents through one delta traversal (hub tables
        from the cache), then swap the snapshot."""
        snap = self._snapshot
        parent = snap.dg if snap.dg is not None else snap.union
        dg = parent.append_edges(**batch)
        token = delta_token(dg, base_token=snap.token)

        new_state = snap.resident_state
        if self._resident is not None:
            # the previous delta config floors this epoch's caps inside
            # the planner (promote_from), which measures pull_edge_cap
            # under the promoted windows; raising a finished plan's caps
            # here would drop triangles. An overflow would corrupt the
            # accumulated state, so it raises.
            cfg_d, _ = plan_delta(
                dg, self.S, self._resident, mode=self.mode,
                push_cap=self.push_cap, pull_q_cap=self.pull_q_cap,
                transport=self.transport, hub_theta=self.hub_theta,
                hub_wedge_cap=self.hub_wedge_cap, max_hubs=self.max_hubs,
                cap_policy=self.cap_policy, on_overflow="raise",
                promote_from=self._shape_hw)
            self._shape_hw = cfg_d
            if self._hub_cache is not None:
                # keep the union-row chain gapless even on epochs whose θ
                # turns hub delegation off (idempotent)
                self._hub_cache.advance(dg)
            bucket = self.cap_policy == "bucket"
            gr_d, _ = shard_delta(dg, self.S, hub_theta=cfg_d.hub_theta,
                                  hub_cache=self._hub_cache,
                                  cap_policy=self.cap_policy,
                                  e_cap_floor=self._ecap_hw if bucket else 0,
                                  d_plus_max_floor=(self._dmax_hw
                                                    if bucket else 0),
                                  device=self.device)
            if bucket:
                self._ecap_hw = max(self._ecap_hw, gr_d.e_cap)
                self._dmax_hw = max(self._dmax_hw, gr_d.d_plus_max)
            fn = self._jit_for(self._resident, cfg_d)
            engine._check_provenance(gr_d, cfg_d)
            merged, dstats = fn(gr_d)
            # guard before merging: an overflow in the delta fold would
            # undercount into every later resident answer
            engine._exactness_guard(cfg_d, dict(dstats))
            new_state = (self._resident.merge_epochs(snap.resident_state,
                                                     merged)
                         if snap.resident_state is not None else merged)

        with self._jit_lock:
            jh, jr = self._jit_hits, self._jit_recompiles
        self._snapshot = Snapshot(epoch=dg.epoch, token=token,
                                  union=dg.union(), dg=dg,
                                  resident_state=new_state,
                                  jit_hits=jh, jit_recompiles=jr)
        self._epochs_applied += 1

    def flush(self) -> None:
        """Block until every submitted batch is merged into the snapshot."""
        self._ingest.flush()

    def ingest_stats(self) -> dict:
        d = {"epochs_applied": self._epochs_applied,
             "pending": self._ingest.pending,
             "epoch": self._snapshot.epoch}
        with self._jit_lock:
            d["jit_cache_hits"] = self._jit_hits
            d["jit_cache_recompiles"] = self._jit_recompiles
            d["jit_cache_entries"] = len(self._compiled)
        d.update(self._ingest.stats())
        if self._hub_cache is not None:
            d["hub_rows_reused"] = self._hub_cache.rows_reused
            d["hub_rows_refreshed"] = self._hub_cache.rows_refreshed
            d["hub_last_build"] = dict(self._hub_cache.last_build)
        return d

    # -- persistence ------------------------------------------------------

    def checkpoint(self, path, *, plans: bool = True) -> None:
        """Persist the current epoch state (graph and token chain) so a
        restarted service derives the same content keys, and unless
        ``plans=False`` every plan-cache entry to a ``.plans.npz`` sidecar
        (:func:`~repro_torch.serve.plan_cache.save_plan_cache`). Both files
        load in either package."""
        snap = self._snapshot
        dg = snap.dg
        if dg is None:
            g = snap.union
            dei, def_ = g.emeta_i.shape[1], g.emeta_f.shape[1]
            dg = DeltaGraph(base=g,
                            d_src=np.zeros(0, np.int64),
                            d_dst=np.zeros(0, np.int64),
                            d_emeta_i=np.zeros((0, dei), np.int32),
                            d_emeta_f=np.zeros((0, def_), np.float32),
                            epoch=snap.epoch)
        gio.save_epoch_state(path, dg, token=snap.token)
        if plans:
            save_plan_cache(_plans_path(path), self.cache)

    @classmethod
    def restore(cls, path, S: int, **kwargs) -> "SurveyService":
        """Rebuild a service from :meth:`checkpoint` output: the token
        chain, and so every content key, continues, and the plan cache is
        preloaded from the ``.plans.npz`` sidecar where there is one (its
        tensors on ``device``), so the first query of a persisted question
        answers from the memoized state."""
        dg, token = gio.load_epoch_state(path)
        if "preload_plans" not in kwargs:
            pp = _plans_path(path)
            if os.path.exists(pp):
                kwargs["preload_plans"] = load_plan_cache(
                    pp, device=kwargs.get("device"))
        return cls(dg.union(), S, token=token, epoch=dg.epoch, **kwargs)

    # -- lifecycle --------------------------------------------------------

    def close(self) -> None:
        self._ingest.close()

    def __enter__(self) -> "SurveyService":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
