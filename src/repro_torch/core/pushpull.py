"""Host-side engine planner + exact communication accounting (Sec. 4.4).

The paper's "Push vs Pull Dry-Run" counts, per (source shard, target
vertex), the adjacency volume that would be pushed, and compares it with
the target's out-degree to choose push or pull. The planning runs on the
host at ingestion time and fixes the static superstep counts and
capacities the engine loops over; the decision rule itself is replicated
on the device (``engine._pull_setup``) so the two always agree. The same
pass yields byte-exact push-only vs push-pull volumes (paper Table 4).

This is host numpy, ported line for line from the JAX package's planner so
that configurations and reports compare field by field. Not ported yet:
the mesh transport's round schedule.
"""
from __future__ import annotations

import hashlib
import weakref
from dataclasses import dataclass, fields as dc_fields

import numpy as np

from repro_torch.analysis.contracts import classify_determinism
from repro_torch.comm.exchange import TRANSPORTS
from repro_torch.core.dodgr import (delta_gen_mask, hub_widths, meta_widths,
                                    orient_edges, sparsify_edges)
from repro_torch.core.engine import EngineConfig
from repro_torch.core.surveys import MetaSpec, Survey
from repro_torch.graphs.csr import DeltaGraph, HostGraph
from repro_torch.utils import bucket_cap, bucket_caps, bucket_floor, ceil_div

__all__ = [
    "VolumeReport", "plan_engine", "plan_delta", "plan_content_key",
    "survey_fingerprint", "graph_token", "advance_token", "delta_token",
    "plan_shape_signature", "bucket_cap", "bucket_caps",
]


@dataclass(frozen=True)
class VolumeReport:
    """Analytic communication volumes (paper Tab. 3 / Tab. 4 quantities).

    Byte quantities use the *projected* per-entry widths (4-byte words) of
    the survey the plan was built for; the ``*_width`` fields expose them,
    with ``full_push_entry_width``/``full_pull_row_width`` keeping the
    all-metadata widths for reference so the projection win is visible
    analytically (``projected_fraction``).

    The ``wire_*`` fields are the *transport-level* volumes: the actual
    buffer slots that cross the shard axis per superstep (including block
    padding — dense pays the worst pair on every pair, ragged pays each
    pair's own histogram), summed over supersteps for the byte totals.
    They match the engine's measured wire stats exactly, per lane, per
    superstep."""

    S: int
    wedges_total: int
    push_only_entries: int
    push_only_bytes: int
    pushpull_push_entries: int
    pushpull_pull_rows: int          # Σ over pulled (s,q) of d₊(q)
    pushpull_requests: int           # # pulled (s,q) pairs
    pushpull_bytes: int
    pulls_per_rank: float            # Tab. 3
    pulled_wedges: int               # wedges resolved locally after pulling
    # --- projected wire-format widths (words per entry) ---
    push_entry_width: int = 0
    pull_row_width: int = 0
    pull_header_width: int = 0
    request_width: int = 2
    full_push_entry_width: int = 0
    full_pull_row_width: int = 0
    # --- delta (epoch-incremental) accounting ---
    gen_wedges: int = 0              # wedges surviving the delta_gen mask
    #                                  (== wedges_total for a full snapshot);
    #                                  every entry/byte quantity above counts
    #                                  only these in delta mode
    epoch: int = 0
    pull_q_cap: int = 0              # resolved cap (autotuned when the call
    #                                  passed pull_q_cap=None)
    pull_row_cap: int = 0            # reply-row padding = max d₊ over pulled
    #                                  groups (hub delegation shrinks it)
    # --- transport + hub delegation (two-tier exchange) ---
    transport: str = "dense"
    hub_theta: int = 0               # chosen degree threshold (0 = no hubs)
    n_hubs: int = 0
    hub_resolved_wedges: int = 0     # wedges closed on-shard via the hub
    #                                  table — zero exchanged bytes
    hub_table_bytes: int = 0         # one-time replication volume of the
    #                                  hub table (S copies, full metadata)
    # --- per-lane wire volumes (transport buffer slots / bytes) ---
    wire_push_slots_step: int = 0    # push-lane slots per superstep, Σ pairs
    wire_req_slots_step: int = 0     # pull-request slots per superstep
    wire_push_bytes: int = 0         # over all push supersteps
    wire_req_bytes: int = 0          # over all pull supersteps
    wire_reply_bytes: int = 0        # padded reply rows, all pull supersteps
    # --- measured stream maxima (what the caps × steps must cover; the
    # static verifier turns runtime truncation warnings into plan-time
    # errors by checking coverage against exactly these) ---
    push_stream_max: int = 0         # heaviest (src, dest) pushed stream
    pull_groups_max: int = 0         # heaviest (src, dest) pulled groups
    hub_stream_max: int = 0          # heaviest per-shard hub wedge stream
    # --- mesh round schedule (transport == "mesh" only; zeros otherwise).
    # The scheduler (comm.round_schedule.best_schedule) and the naive
    # rotation it must never exceed, per wire lane: physical ppermute
    # rounds per superstep and Σ padded slots per device per superstep.
    # MeshExchange recomputes the identical schedule from the same caps
    # (deterministic host-side), and the static verifier proves these
    # numbers against it (analysis.conservation.check_schedule). ---
    sched_push_rounds: int = 0
    sched_push_slots: int = 0        # == MeshExchange.wire_round_slots()
    naive_push_rounds: int = 0
    naive_push_slots: int = 0
    sched_req_rounds: int = 0
    sched_req_slots: int = 0
    naive_req_rounds: int = 0
    naive_req_slots: int = 0
    # --- shape bucketing (cap_policy="bucket"): the exact-policy lane
    # shapes this plan rounded up from, and the wire bytes the bucket
    # grid added on top of them. Always stamped (equal to the primary
    # fields with zero padding under cap_policy="exact"), so the
    # conservation verifier can prove "bucket ≥ exact" on every plan ---
    cap_policy: str = "exact"
    exact_n_push_steps: int = 0
    exact_n_pull_steps: int = 0
    exact_pull_q_cap: int = 0
    exact_pull_row_cap: int = 0
    exact_wire_push_bytes: int = 0
    exact_wire_req_bytes: int = 0
    exact_wire_reply_bytes: int = 0
    bucket_pad_bytes: int = 0        # Σ over the three wire lanes of
    #                                  (bucketed − exact) bytes

    @property
    def bucket_pad_fraction(self) -> float:
        """Bucket-induced padding as a fraction of the (bucketed) wire
        lane bytes — the serving bench gates this at ≤ 15%."""
        total = (self.wire_push_bytes + self.wire_req_bytes
                 + self.wire_reply_bytes)
        return self.bucket_pad_bytes / max(1, total)

    @property
    def reduction(self) -> float:
        return self.push_only_bytes / max(1, self.pushpull_bytes)

    @property
    def projected_fraction(self) -> float:
        """Projected push-entry bytes as a fraction of the full-metadata
        entry — the analytic volume saving of lane projection."""
        return self.push_entry_width / max(1, self.full_push_entry_width)

    @property
    def wire_total_bytes(self) -> int:
        """Everything that crosses the shard axis: all three wire lanes
        plus the one-time hub-table replication."""
        return (self.wire_push_bytes + self.wire_req_bytes
                + self.wire_reply_bytes + self.hub_table_bytes)


# ---------------------------------------------------------------------------
# content keys (serving layer): pure functions from provenance stamps to
# stable hex digests, so a plan cache can recognize "the same question
# against the same graph" across survey instances, epochs, and processes.


def _canon(obj):
    """Canonical, hashable encoding of a survey parameter value. Recurses
    into nested surveys (bundles), MetaSpecs, containers, and numpy scalars;
    anything else falls back to ``repr`` (stable for the plain-value params
    every built-in survey holds)."""
    if isinstance(obj, Survey):
        return ("survey", type(obj).__module__, type(obj).__qualname__,
                _canon(_survey_params(obj)))
    if isinstance(obj, MetaSpec):
        return ("metaspec",) + tuple(
            (f.name, _canon(getattr(obj, f.name))) for f in dc_fields(obj))
    if isinstance(obj, dict):
        return ("dict",) + tuple(sorted(
            (str(k), _canon(v)) for k, v in obj.items()))
    if isinstance(obj, (tuple, list)):
        return ("seq",) + tuple(_canon(v) for v in obj)
    if isinstance(obj, np.generic):
        return ("np", obj.item())
    if obj is None or isinstance(obj, (bool, int, float, str, bytes)):
        return obj
    return ("repr", repr(obj))


def _survey_params(survey) -> dict:
    """The survey's constructor-derived attributes, whether it stores them
    in ``__dict__`` or in ``__slots__`` (the non-weakref-able case)."""
    d = getattr(survey, "__dict__", None)
    if d is not None:
        return d
    out = {}
    for klass in type(survey).__mro__:
        for name in getattr(klass, "__slots__", ()):
            if hasattr(survey, name):
                out[name] = getattr(survey, name)
    return out


def survey_fingerprint(survey) -> str:
    """Stable content key of a survey (or bare :class:`MetaSpec`): class
    identity + every constructor parameter, recursing into bundle members.
    Two instances with equal fingerprints plan, classify, and fold
    identically, so the fingerprint can stand in for the instance in any
    cache key."""
    return hashlib.blake2b(
        repr(_canon(survey)).encode(), digest_size=16).hexdigest()


def graph_token(g: HostGraph) -> str:
    """Content token of a host graph snapshot: edges, metadata, and the
    DOULION stamp. Epoch appends should prefer :func:`advance_token`
    (hash the batch, not the cumulative union)."""
    h = hashlib.blake2b(digest_size=16)
    h.update(repr((g.n, g.m, g.sample_p, g.sample_seed)).encode())
    for a in (g.src, g.dst, g.vmeta_i, g.vmeta_f, g.emeta_i, g.emeta_f):
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def advance_token(token: str, src, dst, emeta_i=None, emeta_f=None,
                  epoch: int | None = None) -> str:
    """Chain-advance a graph token by one appended edge batch: the new token
    commits to the whole epoch history without rehashing the union."""
    h = hashlib.blake2b(digest_size=16)
    h.update(token.encode())
    h.update(repr(("epoch", epoch)).encode())
    for a in (src, dst, emeta_i, emeta_f):
        if a is not None:
            h.update(np.ascontiguousarray(np.asarray(a)).tobytes())
    return h.hexdigest()


def delta_token(dg: DeltaGraph, base_token: str | None = None) -> str:
    """Token of a :class:`DeltaGraph` snapshot: the base's token advanced by
    the overlay. Pass ``base_token`` where the base's token is known."""
    t = base_token if base_token is not None else graph_token(dg.base)
    return advance_token(t, dg.d_src, dg.d_dst, dg.d_emeta_i, dg.d_emeta_f,
                         epoch=dg.epoch)


def plan_content_key(token: str, S: int, survey, *, mode: str = "pushpull",
                     transport: str = "dense", hub_theta="auto",
                     sample_p: float = 1.0, sample_seed: int = 0,
                     orient: str = "degree", epoch: int = 0,
                     cap_policy: str = "exact", extra=()) -> str:
    """Content key of one planned question: everything that can change the
    plan, the sharded graph, or the compiled closure. Any difference in
    (graph epoch/token, survey MetaSpec + params, transport, hub θ, S,
    sampling, orientation, cap policy) yields a different key."""
    fp = survey if isinstance(survey, str) else survey_fingerprint(survey)
    blob = repr((token, S, fp, mode, transport, hub_theta,
                 float(sample_p), int(sample_seed), orient, int(epoch),
                 str(cap_policy), _canon(tuple(extra))))
    return hashlib.blake2b(blob.encode(), digest_size=16).hexdigest()


def plan_shape_signature(cfg: EngineConfig) -> tuple:
    """Every :class:`EngineConfig` field that determines array shapes or
    the structure of the superstep program. ``cfg.epoch`` and
    ``cfg.cap_policy`` are absent: both are host-side bookkeeping."""
    return (cfg.mode, cfg.push_cap, cfg.n_push_steps, cfg.pull_q_cap,
            cfg.pull_edge_cap, cfg.n_pull_steps, cfg.pull_row_cap,
            cfg.meta_widths, cfg.transport, cfg.push_caps, cfg.pull_caps,
            cfg.hub_theta, cfg.n_hub_steps, cfg.hub_wedge_cap, cfg.delta,
            cfg.unroll_steps, cfg.use_pallas, cfg.pull_kernel,
            cfg.cost_model, cfg.sample_p, cfg.sample_seed,
            cfg.project_meta, cfg.orient, cfg.shard_axis)


# determinism verdicts are pure functions of (survey instance, storage
# widths); classification runs three fold hooks, so cache it per survey —
# re-planning every epoch must not re-run them
_det_cache: "weakref.WeakKeyDictionary[Survey, dict]" = \
    weakref.WeakKeyDictionary()
# surveys that take no weak reference fall back to a strong dict keyed by
# content fingerprint: classification still runs once per (survey content,
# widths) instead of once per plan
_det_cache_by_fp: dict = {}
_DET_FP_CACHE_MAX = 1024


def _determinism_of(survey, widths: tuple) -> str:
    """Fold-algebra verdict for the plan's survey (see
    :func:`repro_torch.analysis.contracts.classify_determinism`), cached
    per (survey, storage widths); a bundle is classified whole. A plan
    built from a bare MetaSpec (or none) has no fold to classify: stamped
    ``"unknown"``."""
    if not isinstance(survey, Survey):
        return "unknown"
    try:
        per_widths = _det_cache.setdefault(survey, {})
    except TypeError:
        if len(_det_cache_by_fp) >= _DET_FP_CACHE_MAX:
            _det_cache_by_fp.clear()
        per_widths = _det_cache_by_fp.setdefault(
            survey_fingerprint(survey), {})
    if widths not in per_widths:
        per_widths[widths] = classify_determinism(survey, widths)[0]
    return per_widths[widths]


def _resolve_plan_spec(survey, g: HostGraph) -> MetaSpec:
    if isinstance(survey, str):
        raise TypeError(
            f"plan_engine's third argument is now the survey (or its "
            f"MetaSpec), got {survey!r} — pass mode='{survey}' by keyword")
    if survey is None:
        spec = MetaSpec.full()
    elif isinstance(survey, MetaSpec):
        spec = survey
    else:
        spec = getattr(survey, "meta_spec", MetaSpec.full())
    return spec.resolve(g.spec.dvi, g.spec.dvf, g.spec.dei, g.spec.def_)


def _autotune_pull_q_cap(per_sd: np.ndarray, w_row: int, w_hdr: int,
                         L: int, bucket: bool = False) -> int:
    """Per-survey cap from the measured pulled-group histogram: the smallest
    power of two covering the 95th percentile of per-(shard, dest) pulled
    group counts, so the typical (s, d) pair resolves in one superstep and
    only the heavy tail pays extra steps — instead of every pair paying a
    reply buffer sized for the maximum. The cap is also bounded so one
    padded reply window (``pcap`` rows of ``w_hdr + L·w_row`` words — the
    survey-projected widths, hence *per-survey*) stays within ~4 MiB.

    ``bucket=True`` (``cap_policy="bucket"``) makes the cap *epoch-stable*
    and *on-grid*: every clip endpoint is quantized to the bucket grid —
    the histogram-max bound (the one input that tracks the frontier
    integer-for-integer) rounds UP, the byte bound rounds DOWN (so the
    returned cap never exceeds the ~4 MiB reply-window budget; callers
    must not re-round it up) — and the p95 itself enters only through
    the next power of two, a quantization one octave coarser than the
    grid. The resolved cap is therefore a function only of quantized
    histogram features (pow2 ≥ p95, ``bucket_cap(max)``, and the byte
    bound, which depends only on the already-bucketed ``L``): two epochs
    whose features land in the same buckets resolve the *identical* cap
    — and with it an identical ``EngineConfig`` shape signature
    (asserted in tests/test_bucketing.py). Since powers of two and both
    bounds are grid values, the result is always a grid fixed point."""
    nz = per_sd[per_sd > 0]
    if len(nz) == 0:
        return 32
    p95 = max(1, int(np.percentile(nz, 95)))
    cap = 1
    while cap < p95:
        cap *= 2
    row_words = max(1, w_hdr + L * w_row)
    byte_bound = max(1, (1 << 20) // row_words)  # 2²⁰ words · 4 B = 4 MiB
    hi = int(nz.max())
    if bucket:
        hi = bucket_cap(hi)
        byte_bound = bucket_floor(byte_bound)
    return int(np.clip(cap, 1, max(1, min(hi, byte_bound))))


def _choose_hub_theta(tdeg: np.ndarray, d_plus: np.ndarray,
                      vol_push_v: np.ndarray, req_v: np.ndarray,
                      widths, S: int, w_hub_elem: int, w_hub_hdr: int,
                      max_hubs: int) -> int:
    """Pick the delegation threshold θ from the degree histogram + bytes
    cost model, by minimizing total wire words over the degree-threshold
    family:

        cost(θ) = P(θ)·w_push                             (pushed wedges)
                + R(θ)·(w_req + w_hdr + Lr(θ)·w_row)      (pulls, rows
                                                           padded to the
                                                           heaviest pulled
                                                           survivor Lr)
                + S·Σ_{deg ≥ θ} (d₊·w_elem + w_hdr_hub)   (hub table)

    The Lr term is what makes delegation decisive on skewed graphs: every
    padded reply row is sized by the worst still-pulled ``Adj₊`` row, so
    delegating the few heaviest rows shrinks *every* reply in the epoch.
    Returns 0 (delegate nothing) when the undelegated plan is cheapest."""
    w_push, w_row, w_hdr, w_req = widths
    n = len(tdeg)
    if n == 0 or max_hubs < 1:
        return 0
    order = np.argsort(-tdeg, kind="stable")
    d_sorted = tdeg[order]
    if d_sorted[0] < 1:
        return 0
    vp = vol_push_v[order].astype(np.int64)
    rq = req_v[order].astype(np.int64)
    dp = d_plus[order].astype(np.int64)
    cum_vp = np.concatenate([[0], np.cumsum(vp)])
    cum_rq = np.concatenate([[0], np.cumsum(rq)])
    cum_tab = np.concatenate(
        [[0], np.cumsum(S * (dp * np.int64(w_hub_elem) + w_hub_hdr))])
    # Lr after delegating prefix [0, k): max d₊ over still-pulled vertices
    dmax_pull = np.where(rq > 0, dp, 0)
    sufmax = np.concatenate(
        [np.maximum.accumulate(dmax_pull[::-1])[::-1], [0]])
    P0, R0 = int(vp.sum()), int(rq.sum())

    def cost(k):
        P = P0 - cum_vp[k]
        R = R0 - cum_rq[k]
        lr = max(1, int(sufmax[k]))
        return (P * w_push + R * (w_req + w_hdr + lr * w_row) + cum_tab[k])

    # threshold candidates: prefixes ending where the degree strictly
    # drops, so θ = d_sorted[k-1] always includes every vertex of that
    # degree; prefix length bounded by max_hubs
    last_of_deg = np.ones(n, bool)
    last_of_deg[:-1] = d_sorted[1:] != d_sorted[:-1]
    ks = np.nonzero(last_of_deg & (np.arange(n) < max_hubs)
                    & (d_sorted >= 1))[0] + 1
    if len(ks) == 0:
        return 0
    costs = np.array([cost(int(k)) for k in ks])
    best = int(np.argmin(costs))
    if costs[best] >= cost(0):
        return 0
    return int(d_sorted[ks[best] - 1])


def plan_engine(
    g: HostGraph,
    S: int,
    survey: Survey | MetaSpec | None = None,
    mode: str = "pushpull",
    push_cap: int = 256,
    pull_q_cap: int | None = None,
    cost_model: str = "entries",
    use_pallas: bool = False,
    shard_axis: str | None = None,
    sample_p: float = 1.0,
    sample_seed: int = 0,
    orient: str = "degree",
    edge_new: np.ndarray | None = None,
    epoch: int = 0,
    transport: str = "dense",
    hub_theta: int | str = 0,
    hub_wedge_cap: int = 256,
    max_hubs: int = 1024,
    on_overflow: str = "warn",
    cap_policy: str = "exact",
    promote_from: EngineConfig | None = None,
) -> tuple[EngineConfig, VolumeReport]:
    """Plan static superstep counts/capacities and account communication.

    Arguments and semantics are the JAX package's ``plan_engine``:
    ``survey`` (a :class:`Survey` or bare :class:`MetaSpec`) narrows every
    byte quantity to the lanes it reads; ``pull_q_cap=None`` autotunes the
    pulled-group cap (:func:`_autotune_pull_q_cap`); ``sample_p < 1`` plans
    the DOULION view ``shard_dodgr`` ingests; ``transport="ragged"`` stamps
    per-(shard, dest) capacities; ``hub_theta`` picks or forces the hub
    threshold (:func:`_choose_hub_theta`); ``cap_policy="bucket"`` rounds
    every shape-determining capacity up to the bucket grid after every
    decision (results stay bitwise equal to ``"exact"``); ``promote_from``
    raises a bucketed plan's caps to a previous plan's before the
    dependent quantities are derived. ``edge_new`` plans a delta frontier
    (prefer :func:`plan_delta`).

    ``use_pallas`` is stamped into the config for parity with the JAX
    package (whose default is ``False``); in the port the device alone
    decides between the CUDA kernels and their plain versions.
    """
    if transport not in TRANSPORTS:
        raise ValueError(f"transport must be one of {TRANSPORTS}, "
                         f"got {transport!r}")
    if transport == "mesh":
        raise NotImplementedError(
            "transport='mesh' (and its round schedule) is not ported yet; "
            "see ROADMAP.md, Queue 1 item 8")
    if cap_policy not in ("exact", "bucket"):
        raise ValueError(f"cap_policy must be 'exact' or 'bucket', "
                         f"got {cap_policy!r}")
    bucket = cap_policy == "bucket"
    g = sparsify_edges(g, sample_p, sample_seed)
    sample_p, sample_seed = g.sample_p, g.sample_seed
    delta = edge_new is not None
    p, q, deg, h = orient_edges(g, orient)
    d_plus = np.bincount(p, minlength=g.n).astype(np.int64)
    s = (p % S).astype(np.int64)
    d = (q % S).astype(np.int64)
    local = p // S
    n_loc = ceil_div(g.n, S)

    # per-edge suffix length, identical to device: sort edges by
    # (owner, local row, key(q)); suffix = row_len - pos_in_row - 1
    order = np.lexsort((q, h[q], deg[q], local, s))
    p_o, q_o, s_o, d_o = p[order], q[order], s[order], d[order]
    row_key = s_o * n_loc + local[order]
    _, row_start, row_len = np.unique(row_key, return_index=True, return_counts=True)
    pos = np.arange(len(p_o)) - np.repeat(row_start, row_len)
    suffix = (np.repeat(row_len, row_len) - pos - 1).astype(np.int64)

    if delta:
        new_o = np.asarray(edge_new, bool)[order]
        touched = np.zeros(g.n, bool)
        touched[g.src[edge_new]] = True
        touched[g.dst[edge_new]] = True
        gen = delta_gen_mask(q_o, row_start, row_len, new_o, touched)
        suffix_w = suffix * gen
    else:
        suffix_w = suffix

    rspec = _resolve_plan_spec(survey, g)
    w_push, w_row, w_hdr, w_req = meta_widths(*rspec.lane_counts())
    if delta:
        # on-wire newness: (pq_new, pr_new) bits on each push entry, r_new
        # on each pulled row — one packed word apiece
        w_push += 1
        w_row += 1
    full_spec = MetaSpec.full().resolve(g.spec.dvi, g.spec.dvf,
                                        g.spec.dei, g.spec.def_)
    w_push_full, w_row_full, _, _ = meta_widths(*full_spec.lane_counts())

    # vol(s, q) and the pull decision (paper's inequality), over the wedges
    # this plan will actually generate
    sq = s_o * np.int64(g.n) + q_o
    uq, inv = np.unique(sq, return_inverse=True)
    vol = np.bincount(inv, weights=suffix_w).astype(np.int64)
    gv = (uq % np.int64(g.n)).astype(np.int64)
    dq_of_group = d_plus[gv]
    if mode == "push":
        base_pull = np.zeros(len(uq), bool)
    elif cost_model == "entries":
        base_pull = dq_of_group < vol
    else:
        base_pull = dq_of_group * w_row + w_hdr + w_req < vol * w_push

    # --- hub delegation: θ from the degree histogram + bytes cost model ---
    w_hub_elem, w_hub_hdr = hub_widths(g.spec.dvi, g.spec.dvf, g.spec.dei,
                                       g.spec.def_, delta=delta)
    tdeg = (deg if orient == "degree" else g.degrees()).astype(np.int64)
    theta = 0
    if hub_theta == "auto":
        # per-vertex wire load under the baseline plan: pushed wedge volume
        # and pulled-group count — delegation erases exactly these, and
        # removing the heaviest pulled rows also shrinks the reply padding
        vol_push_v = np.bincount(gv[~base_pull], weights=vol[~base_pull],
                                 minlength=g.n).astype(np.int64)
        req_v = np.bincount(gv[base_pull], minlength=g.n).astype(np.int64)
        theta = _choose_hub_theta(tdeg, d_plus, vol_push_v, req_v,
                                  (w_push, w_row, w_hdr, w_req), S,
                                  w_hub_elem, w_hub_hdr, max_hubs)
    elif hub_theta:
        theta = int(hub_theta)
        if theta < 1:
            raise ValueError(f"hub_theta must be ≥ 1 (or 0/'auto'), "
                             f"got {theta}")

    # session shape hysteresis: the previous epoch's caps are floors, but
    # only within one plan structure — a different mode/transport/θ/width
    # (or policy, or shard count) resets the mark to this plan alone
    prev = promote_from if bucket else None
    if prev is not None and not (
            prev.cap_policy == "bucket" and prev.mode == mode
            and prev.transport == transport and prev.delta == delta
            and prev.hub_theta == theta
            and prev.meta_widths == (w_push, w_row, w_hdr, w_req)
            and (prev.push_caps is None or len(prev.push_caps) == S)):
        prev = None

    if theta >= 1:
        hub_v = tdeg >= theta
        n_hubs = int(hub_v.sum())
        hub_e = hub_v[q_o]
        pull_group = base_pull & ~hub_v[gv]
        hub_table_bytes = int(S * (d_plus[hub_v] * w_hub_elem
                                   + w_hub_hdr).sum()) * 4
    else:
        n_hubs = 0
        hub_e = np.zeros(len(q_o), bool)
        pull_group = base_pull
        hub_table_bytes = 0
    pull_e = pull_group[inv]
    push_e = ~pull_e & ~hub_e

    wedges_total = int(suffix.sum())
    gen_wedges = int(suffix_w.sum())
    hub_w = suffix_w * hub_e
    hub_resolved = int(hub_w.sum())
    hub_per_shard = np.bincount(s_o, weights=hub_w, minlength=S)
    if bucket:
        hub_wedge_cap = bucket_cap(hub_wedge_cap)
        if prev is not None:
            hub_wedge_cap = max(hub_wedge_cap, prev.hub_wedge_cap)
    n_hub_steps = (ceil_div(int(hub_per_shard.max()), hub_wedge_cap)
                   if hub_resolved else 0)
    if bucket:
        n_hub_steps = bucket_cap(n_hub_steps)
        if prev is not None:
            # extra hub supersteps only scan empty (masked) wedge slots
            n_hub_steps = max(n_hub_steps, prev.n_hub_steps)

    pushed = suffix_w[push_e]
    sd = s_o * S + d_o
    push_stream = np.bincount(sd[push_e], weights=pushed, minlength=S * S)
    max_push_stream = int(push_stream.max()) if len(push_stream) else 0
    # exact-policy lane shape, always derived: the report stamps it next
    # to the (possibly bucketed) primary values so the padding is auditable
    exact_n_push_steps = max(1, ceil_div(max_push_stream, push_cap))
    if transport in ("ragged", "mesh"):
        exact_push_slots = int(
            (-(-push_stream.astype(np.int64) // exact_n_push_steps)).sum())
    else:
        exact_push_slots = S * S * push_cap
    if bucket:
        push_cap = bucket_cap(push_cap)
        if prev is not None:
            push_cap = max(push_cap, prev.push_cap)
    n_push_steps = max(1, ceil_div(max_push_stream, push_cap))
    if bucket:
        n_push_steps = bucket_cap(n_push_steps)
        if prev is not None:
            n_push_steps = max(n_push_steps, prev.n_push_steps)
    push_caps = None
    if transport in ("ragged", "mesh"):
        # per-pair caps derive from the already-promoted step count, so
        # n_steps × cap still covers each pair's stream; the push lane's
        # window width equals its slot count, so raising either is pure
        # masked padding (unlike the pull lane's edge windows below)
        pc = -(-push_stream.astype(np.int64) // n_push_steps)
        if bucket:
            pc = bucket_caps(pc)
            if prev is not None and prev.push_caps is not None:
                pc = np.maximum(
                    pc, np.asarray(prev.push_caps, np.int64).reshape(-1))
        push_caps = tuple(tuple(int(x) for x in row)
                          for row in pc.reshape(S, S))

    # pulled groups per (s, d) → pull supersteps; edge windows → edge cap
    n_pull_steps = 0
    pull_edge_cap = 1
    pull_caps = None
    pull_row_cap = 0
    pull_groups_max = 0
    exact_pull_row_cap = 0
    exact_pull_q_cap = int(pull_q_cap) if pull_q_cap is not None else 0
    exact_n_pull_steps = 0
    exact_req_slots = 0
    n_pulled_groups = int(pull_group.sum())
    if mode == "pushpull" and n_pulled_groups:
        g_s = (uq // np.int64(g.n))[pull_group]
        g_q = (uq % np.int64(g.n))[pull_group]
        g_d = g_q % S
        # reply rows pad to the heaviest row actually pulled — under hub
        # delegation the heavy rows left the pull set, so this (and the
        # dominant reply volume) shrinks to the heaviest survivor
        exact_pull_row_cap = max(1, int(d_plus[g_q].max()))
        pull_row_cap = (bucket_cap(exact_pull_row_cap) if bucket
                        else exact_pull_row_cap)
        if prev is not None:
            pull_row_cap = max(pull_row_cap, prev.pull_row_cap)
        per_sd = np.bincount(g_s * S + g_d, minlength=S * S)
        pull_groups_max = int(per_sd.max())
        if pull_q_cap is None:
            exact_pull_q_cap = _autotune_pull_q_cap(per_sd, w_row, w_hdr,
                                                    exact_pull_row_cap)
            # the bucket=True autotune is already on-grid within the
            # reply-window byte bound — re-rounding up here would breach it
            pull_q_cap = (_autotune_pull_q_cap(per_sd, w_row, w_hdr,
                                               pull_row_cap, bucket=True)
                          if bucket else exact_pull_q_cap)
        elif bucket:
            pull_q_cap = bucket_cap(int(pull_q_cap))
        if prev is not None:
            pull_q_cap = max(pull_q_cap, prev.pull_q_cap)
        exact_n_pull_steps = max(1, ceil_div(pull_groups_max,
                                             exact_pull_q_cap))
        n_pull_steps = max(1, ceil_div(pull_groups_max, pull_q_cap))
        if bucket:
            n_pull_steps = bucket_cap(n_pull_steps)
            if prev is not None:
                n_pull_steps = max(n_pull_steps, prev.n_pull_steps)
        if transport in ("ragged", "mesh"):
            exact_req_slots = int(
                (-(-per_sd.astype(np.int64) // exact_n_pull_steps)).sum())
            pc = -(-per_sd.astype(np.int64) // n_pull_steps)
            if bucket:
                pc = bucket_caps(pc)
                if prev is not None and prev.pull_caps is not None:
                    pc = np.maximum(
                        pc, np.asarray(prev.pull_caps, np.int64).reshape(-1))
            pull_caps = tuple(tuple(int(x) for x in row)
                              for row in pc.reshape(S, S))
            caps_of_sd = pc
        else:
            exact_req_slots = S * S * exact_pull_q_cap
            caps_of_sd = np.full(S * S, pull_q_cap, np.int64)
        # edges per (s,d,window): group rank within (s,d) in (q) order,
        # window = rank // cap(s,d); edge count per window
        grp_order = np.lexsort((g_q, g_d, g_s))
        gsd = (g_s * S + g_d)[grp_order]
        rank_in_sd = np.arange(len(gsd)) - np.searchsorted(gsd, gsd, side="left")
        win = rank_in_sd // np.maximum(caps_of_sd[gsd], 1)
        # map each pulled edge to its group's window
        grp_win = np.empty(len(uq), np.int64)
        pulled_idx = np.nonzero(pull_group)[0]
        grp_win_vals = np.empty(len(gsd), np.int64)
        grp_win_vals[grp_order] = win
        grp_win[pulled_idx] = grp_win_vals
        e_win = grp_win[inv[pull_e]]
        e_sd = sd[pull_e]
        key = e_sd * (int(win.max()) + 1 if len(win) else 1) + e_win
        per_window = np.bincount(key)
        # the window partition above used the policy-resolved (and, under
        # hysteresis, promoted) caps, so the edge windows the engine
        # executes match — this is why promotion lives in the planner:
        # pull_edge_cap is only valid for the exact caps_of_sd it was
        # measured under. The cap itself buckets (and promotes) like
        # every other shape knob: raising it only widens masked slots.
        pull_edge_cap = max(1, int(per_window.max()))
        if bucket:
            pull_edge_cap = bucket_cap(pull_edge_cap)
            if prev is not None:
                pull_edge_cap = max(pull_edge_cap, prev.pull_edge_cap)
    if pull_q_cap is None:
        pull_q_cap = 32  # nothing pulled — any cap is a no-op
        exact_pull_q_cap = 32
    elif bucket:
        pull_q_cap = bucket_cap(int(pull_q_cap))
    if (prev is not None and mode == "pushpull" and not n_pulled_groups
            and prev.n_pull_steps):
        # nothing pulled this epoch but the session shape has a pull lane:
        # adopt it wholesale — every window scans zero groups, so the
        # promoted lane is pure masked padding and the shape signature
        # (hence the executable) repeats
        pull_q_cap = max(pull_q_cap, prev.pull_q_cap)
        n_pull_steps = prev.n_pull_steps
        pull_edge_cap = max(pull_edge_cap, prev.pull_edge_cap)
        pull_row_cap = max(pull_row_cap, prev.pull_row_cap)
        if prev.pull_caps is not None:
            pull_caps = prev.pull_caps
    if transport in ("ragged", "mesh") and pull_caps is None:
        pull_caps = tuple((0,) * S for _ in range(S))

    # --- volumes ---
    push_only_entries = gen_wedges - hub_resolved
    push_only_bytes = push_only_entries * w_push * 4 + hub_table_bytes
    pp_push_entries = int(pushed.sum())
    pp_rows = int(d_plus[(uq % np.int64(g.n))[pull_group]].sum())
    pp_bytes = (pp_push_entries * w_push + n_pulled_groups * (w_req + w_hdr)
                + pp_rows * w_row) * 4 + hub_table_bytes
    # --- transport wire volumes (buffer slots that actually cross shards,
    # block padding included — must equal the engine's measured stats) ---
    if transport in ("ragged", "mesh"):
        push_slots = int(sum(sum(row) for row in push_caps))
        req_slots = int(sum(sum(row) for row in pull_caps)) if pull_caps else 0
    else:
        push_slots = S * S * push_cap
        req_slots = S * S * pull_q_cap if n_pull_steps else 0
    wire_push_bytes = n_push_steps * push_slots * w_push * 4
    wire_req_bytes = n_pull_steps * req_slots * w_req * 4
    wire_reply_bytes = (n_pull_steps * req_slots
                        * (w_hdr + pull_row_cap * w_row) * 4)
    # exact-policy wire bytes (== the primary fields under cap_policy=
    # "exact"): the bucket grid's padding tax is their difference — the
    # cost model stays honest about what bucketing added to the wire
    exact_wire_push_bytes = exact_n_push_steps * exact_push_slots * w_push * 4
    exact_wire_req_bytes = exact_n_pull_steps * exact_req_slots * w_req * 4
    exact_wire_reply_bytes = (exact_n_pull_steps * exact_req_slots
                              * (w_hdr + exact_pull_row_cap * w_row) * 4)
    bucket_pad_bytes = ((wire_push_bytes + wire_req_bytes + wire_reply_bytes)
                        - (exact_wire_push_bytes + exact_wire_req_bytes
                           + exact_wire_reply_bytes))
    # --- mesh round schedule: the planner stamps the same deterministic
    # schedule the transport will execute, so the report carries the
    # physical wire structure (and the naive-rotation bound) per lane ---
    sched = dict(sched_push_rounds=0, sched_push_slots=0,
                 naive_push_rounds=0, naive_push_slots=0,
                 sched_req_rounds=0, sched_req_slots=0,
                 naive_req_rounds=0, naive_req_slots=0)
    report = VolumeReport(
        S=S,
        wedges_total=wedges_total,
        push_only_entries=push_only_entries,
        push_only_bytes=push_only_bytes,
        pushpull_push_entries=pp_push_entries,
        pushpull_pull_rows=pp_rows,
        pushpull_requests=n_pulled_groups,
        pushpull_bytes=pp_bytes if mode == "pushpull" else push_only_bytes,
        pulls_per_rank=n_pulled_groups / S,
        pulled_wedges=int(suffix_w[pull_e].sum()),
        push_entry_width=w_push,
        pull_row_width=w_row,
        pull_header_width=w_hdr,
        request_width=w_req,
        full_push_entry_width=w_push_full,
        full_pull_row_width=w_row_full,
        gen_wedges=gen_wedges,
        epoch=epoch,
        pull_q_cap=pull_q_cap,
        pull_row_cap=pull_row_cap,
        transport=transport,
        hub_theta=theta,
        n_hubs=n_hubs,
        hub_resolved_wedges=hub_resolved,
        hub_table_bytes=hub_table_bytes,
        wire_push_slots_step=push_slots,
        wire_req_slots_step=req_slots,
        wire_push_bytes=wire_push_bytes,
        wire_req_bytes=wire_req_bytes,
        wire_reply_bytes=wire_reply_bytes,
        push_stream_max=max_push_stream,
        pull_groups_max=pull_groups_max,
        hub_stream_max=int(hub_per_shard.max()) if hub_resolved else 0,
        cap_policy=cap_policy,
        exact_n_push_steps=exact_n_push_steps,
        exact_n_pull_steps=exact_n_pull_steps,
        exact_pull_q_cap=exact_pull_q_cap,
        exact_pull_row_cap=exact_pull_row_cap,
        exact_wire_push_bytes=exact_wire_push_bytes,
        exact_wire_req_bytes=exact_wire_req_bytes,
        exact_wire_reply_bytes=exact_wire_reply_bytes,
        bucket_pad_bytes=bucket_pad_bytes,
        **sched,
    )
    cfg = EngineConfig(
        mode=mode,
        push_cap=push_cap,
        n_push_steps=n_push_steps,
        pull_q_cap=pull_q_cap,
        pull_edge_cap=pull_edge_cap,
        n_pull_steps=n_pull_steps,
        pull_row_cap=pull_row_cap,
        cost_model=cost_model,
        use_pallas=use_pallas,
        shard_axis=shard_axis,
        sample_p=sample_p,
        sample_seed=sample_seed,
        meta_widths=(w_push, w_row, w_hdr, w_req),
        delta=delta,
        epoch=epoch,
        orient=orient,
        transport=transport,
        push_caps=push_caps,
        pull_caps=pull_caps,
        hub_theta=theta,
        n_hub_steps=n_hub_steps,
        hub_wedge_cap=hub_wedge_cap,
        on_overflow=on_overflow,
        cap_policy=cap_policy,
        determinism=_determinism_of(
            survey, (g.spec.dvi, g.spec.dvf, g.spec.dei, g.spec.def_)),
    )
    return cfg, report


def plan_delta(
    dg: DeltaGraph,
    S: int,
    survey: Survey | MetaSpec | None = None,
    orient: str = "stable",
    **kwargs,
) -> tuple[EngineConfig, VolumeReport]:
    """Plan one incremental epoch: only the delta frontier's generated
    wedges (the three new-triangle classes), stamped with the epoch so
    ``engine.survey_delta`` can check it against the matching
    :func:`~repro_torch.core.dodgr.shard_delta`. Takes every
    :func:`plan_engine` keyword; ``hub_theta="auto"`` weighs only the
    epoch's masked wedge volumes. Pass the chosen ``cfg.hub_theta`` to
    ``shard_delta``.
    """
    h, edge_new = dg.frontier()
    return plan_engine(h, S, survey, orient=orient, edge_new=edge_new,
                       epoch=dg.epoch, **kwargs)
