"""TriPoll survey engine: Push-Only (Alg. 1) and Push-Pull (Sec. 4.4).

All S logical shards are stacked on one device: every per-shard tensor
carries a leading ``[S, ...]`` axis written out (the JAX package's
``vmap`` over shards), and the static superstep counts of the host
planner (:mod:`repro_torch.core.pushpull`) become Python loops. Cross-shard
buffer movement goes through :mod:`repro_torch.comm.exchange`.

Push superstep: shard s enumerates wedges (p; q, r) rank by rank within
each destination stream and ships (q, r, key(r), meta(p), meta(pq),
meta(pr)) to owner(q); the owner closes the wedge with a keyed lower bound
of r in Adj₊(q) — the ``wedge_check`` kernel — and folds the survey.

Pull superstep: shard s requests Adj₊ᵐ(q) once per (shard, q) for targets
whose row is cheaper to move than the wedge candidates, receives padded
rows, intersects its local suffixes against them — the ``wedge_intersect``
kernel — and folds locally. The pull window of one requesting shard is
``[S_dest, pull_edge_cap, d_plus_max]`` lanes; the engine builds it and
folds it one requesting shard at a time, so its temporaries take 1/S of
the whole window's memory.

``pull_kernel="split"`` takes the pull lane's unfused form instead: the
candidate keys are gathered into ``[B, L]`` arrays and lower-bounded in
the pulled rows by the ``intersect`` kernel. Both forms give the same
positions, so results and stats are the same.

Kernel or plain: the device alone decides. On CUDA tensors the push and
pull searches and the survey folds launch the hand-written kernels
(``repro_torch/csrc``); on CPU tensors they run the kernels' plain PyTorch
versions; on meta tensors (a dry-run trace, ``launch/dryrun.py``) they
give the kernels' output shapes. ``EngineConfig.use_pallas`` and ``pallas_interpret`` are kept so
configurations compare field by field with the JAX package, whose
``plan_engine`` defaults to ``use_pallas=False``; they choose nothing here.

Hub superstep: wedges whose centre q has degree ≥ the plan's
``hub_theta`` reach neither wire lane. q's ``Adj₊`` row is replicated on
every shard (``shard_dodgr(hub_theta=θ)``), so the source shard closes the
wedge against the hub table (one ``wedge_check`` launch over the table
flattened to one key row) and folds locally.

Delta mode (``EngineConfig.delta``): the graph is a delta frontier
(``shard_delta``) and the same lanes run restricted. Wedge generation is
masked to the ``delta_gen`` edges, push entries and pulled rows carry
per-edge newness bits, and a triangle is folded only where one of its
edges is new. ``survey_delta`` accumulates epochs through
``Survey.merge_epochs``; ``finalize_epochs`` renders the running state.

Stats are float32 sums, as in the JAX package: each superstep adds one
exact integer per stat, in the same order, so the values agree bit for bit
(and round the same way once a total passes 2²⁴).

Mesh lowering (``make_survey_fn(..., mesh=)``): one shard per
``torch.distributed`` rank, the same superstep body on the rank's slice
(leading axis 1, while routing and local ids keep the true S), every
exchange a real collective (:mod:`repro_torch.comm.mesh_exchange`), the
states all-gathered and merged in rank order.
"""
from __future__ import annotations

import warnings
from dataclasses import dataclass, replace

import numpy as np
import torch

from repro_torch.comm.exchange import Exchange, make_exchange
from repro_torch.core.dodgr import ShardedDODGr, meta_widths, shard_slice
from repro_torch.core.surveys import (MetaSpec, Survey, TriangleBatch,
                                      expand_lanes, narrow_lanes,
                                      project_lanes, tree_map)
from repro_torch.kernels.intersect import ops as is_ops
from repro_torch.kernels.wedge_check import ops as wc_ops
from repro_torch.kernels.wedge_intersect import ops as wi_ops

BIG_I32 = 2**30
U32_ONES = -1   # 0xFFFFFFFF as int32 bits: the reply-row hash sentinel


# ---------------------------------------------------------------------------
# config


@dataclass(frozen=True)
class EngineConfig:
    """Static engine plan, field for field the JAX package's. Produced by
    ``pushpull.plan_engine`` on the host."""

    mode: str = "push"            # "push" | "pushpull"
    push_cap: int = 256           # wedge slots per (shard,dest) per push superstep
    n_push_steps: int = 1
    pull_q_cap: int = 32          # pulled-row slots per (shard,dest) per pull superstep
    pull_edge_cap: int = 64       # edge slots per (shard,dest) pull window
    n_pull_steps: int = 0
    cost_model: str = "entries"   # "entries" (paper-faithful) | "bytes"
    unroll_steps: bool = False    # kept for parity; the loops are Python loops
    use_pallas: bool = False      # kept for parity; the device decides
    pallas_interpret: bool = True  # kept for parity; the device decides
    pull_kernel: str = "auto"     # "auto"/"fused": wedge_intersect; "split":
    #                               gathered candidates + intersect
    shard_axis: str | None = None  # kept for parity (mesh sharding hint)
    sample_p: float = 1.0         # DOULION edge-keep probability
    sample_seed: int = 0
    project_meta: bool = True     # lane-project metadata to the survey's MetaSpec
    meta_widths: tuple | None = None  # (w_push, w_row, w_hdr, w_req) words
    delta: bool = False           # epoch-incremental mode
    epoch: int = 0
    orient: str = "degree"
    transport: str = "dense"      # "dense" | "ragged" | "mesh"
    push_caps: tuple | None = None  # ragged: S×S wedge slots per (src, dest)
    pull_caps: tuple | None = None  # ragged: S×S pulled-group slots per (src, dest)
    pull_row_cap: int = 0         # reply-row padding (0 = d_plus_max)
    hub_theta: int = 0            # hub delegation threshold θ (0 = off)
    n_hub_steps: int = 0          # hub-lane supersteps (0 = lane off)
    hub_wedge_cap: int = 256
    on_overflow: str = "warn"     # "warn" | "raise"
    cap_policy: str = "exact"     # "exact" | "bucket" (host bookkeeping)
    determinism: str = "bitwise"  # fold-algebra verdict stamped by the planner


def _push_exchange(cfg: EngineConfig, S: int) -> Exchange:
    return make_exchange(cfg.transport, S, cfg.push_cap, cfg.push_caps)


def _pull_exchange(cfg: EngineConfig, S: int) -> Exchange:
    return make_exchange(cfg.transport, S, cfg.pull_q_cap, cfg.pull_caps)


# ---------------------------------------------------------------------------
# stacked-shard helpers


def _take(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Per-shard gather along axis 1: ``x`` [S, N, ...], ``idx`` [S, ...]
    → ``x[s, idx[s, ...]]``."""
    S = x.shape[0]
    s = torch.arange(S, device=x.device).view((S,) + (1,) * (idx.dim() - 1))
    return x[s, idx.long()]


def _arange_rows(S: int, n: int, device) -> torch.Tensor:
    """[S, n] int32 rows of 0..n-1 (batched searchsorted probes)."""
    return torch.arange(n, dtype=torch.int32, device=device).expand(S, n).contiguous()


def _lookup(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``where(i > 0, x[:, i - 1], 0)`` — an exclusive prefix read of the
    inclusive cumsum ``x`` [S, N] at positions ``i`` [S, ...]."""
    v = torch.gather(x, 1, (i - 1).clamp_min(0).long())
    return torch.where(i > 0, v, 0)


# ---------------------------------------------------------------------------
# push lane


def _stream_setup(gr: ShardedDODGr, weight_mask=None) -> dict:
    """Dest-major wedge-stream routing tables, [S, ...] per field:

      perm       dest-sorted edge permutation
      cum        inclusive cumsum of wedge weights in perm order
      base       exclusive stream offset at each dest block  [S, S]
      stream_len wedges per dest [S, S]
      suffix     per-edge suffix length (wedge fanout)
      dest       owner(q) per edge
      valid      edge-slot validity
    """
    S, E, n_loc = gr.S, gr.e_cap, gr.n_loc
    S_ax = gr.row_ptr.shape[0]
    dev = gr.device
    e = torch.arange(E, dtype=torch.int32, device=dev)[None, :]
    valid = e < gr.row_ptr[:, -1:]
    lp = (gr.edge_src // S).clamp(0, n_loc - 1)
    row_end = torch.gather(gr.row_ptr, 1, (lp + 1).long())
    suffix = torch.where(valid, (row_end - e - 1).clamp_min(0), 0)
    dest = torch.where(valid, gr.nbr % S, S)
    perm = torch.sort(dest, dim=1, stable=True).indices
    w = torch.gather(suffix, 1, perm)
    if weight_mask is not None:
        w = w * torch.gather(weight_mask, 1, perm).to(torch.int32)
    cum = torch.cumsum(w, 1, dtype=torch.int32)
    sorted_dest = torch.gather(dest, 1, perm)
    dest_start = torch.searchsorted(sorted_dest, _arange_rows(S_ax, S + 1, dev),
                                    out_int32=True)
    base = _lookup(cum, dest_start)             # [S, S+1]; base[:, S] == total
    stream_len = base[:, 1:] - base[:, :-1]
    return dict(perm=perm, cum=cum, base=base[:, :-1].contiguous(),
                stream_len=stream_len, suffix=suffix, dest=dest, valid=valid)


def _gen_push_queries(gr: ShardedDODGr, st: dict, t: int, exch: Exchange,
                      spec: MetaSpec, delta: bool = False) -> dict:
    """Flat [S, out_cap] wire buffers of push queries for superstep ``t``:
    slot j of shard s is rank ``t·cap(s,d) + lane(j)`` of the dest-d wedge
    stream. Metadata travels in wire form (declared lanes only); in delta
    mode one more word carries the newness of the wedge's edges pq and
    pr."""
    S, E, n_loc = gr.S, gr.e_cap, gr.n_loc
    dev = gr.device
    dest_of = exch.tensor("dest_of", dev)
    lane_of = exch.tensor("lane_of", dev)
    cap_of = exch.tensor("cap_of", dev)
    d = dest_of.clamp_max(S - 1).long()
    offs = t * cap_of + lane_of
    in_stream = (dest_of < S) & (offs < torch.gather(st["stream_len"], 1, d))
    ranks = torch.gather(st["base"], 1, d) + offs
    idx = torch.searchsorted(st["cum"], ranks, right=True, out_int32=True)
    idx = idx.clamp(0, E - 1)
    e = torch.gather(st["perm"], 1, idx.long())
    o = (ranks - _lookup(st["cum"], idx)).clamp(0, E - 1)
    r_pos = (e + 1 + o).clamp(0, E - 1)
    p = torch.gather(gr.edge_src, 1, e)
    lp = (p // S).clamp(0, n_loc - 1)
    out = dict(
        q=torch.gather(gr.nbr, 1, e), r=torch.gather(gr.nbr, 1, r_pos),
        rd=torch.gather(gr.nbr_d, 1, r_pos), rh=torch.gather(gr.nbr_h, 1, r_pos),
        p=p,
        vp_i=_take(project_lanes(gr.vmeta_i, spec.vp_i), lp),
        vp_f=_take(project_lanes(gr.vmeta_f, spec.vp_f), lp),
        epq_i=_take(project_lanes(gr.emeta_i, spec.e_pq_i), e),
        epq_f=_take(project_lanes(gr.emeta_f, spec.e_pq_f), e),
        epr_i=_take(project_lanes(gr.emeta_i, spec.e_pr_i), r_pos),
        epr_f=_take(project_lanes(gr.emeta_f, spec.e_pr_f), r_pos),
        ok=in_stream,
    )
    if delta:
        out["new2"] = (torch.gather(gr.nbr_new, 1, e).to(torch.int32)
                       | (torch.gather(gr.nbr_new, 1, r_pos).to(torch.int32) << 1))
    return out


def _answer_push_queries(gr: ShardedDODGr, qr: dict, cfg: EngineConfig,
                         spec: MetaSpec) -> TriangleBatch:
    """Owner-side wedge closure, all shards in one ``wedge_check`` launch:
    search key(r) in Adj₊(q); gather owner-local metadata at declared
    width; expand shipped lanes to fold form."""
    S, E, n_loc = gr.S, gr.e_cap, gr.n_loc
    lq = (qr["q"] // S).clamp(0, n_loc - 1)
    lo = _take(gr.row_ptr, lq)
    hi = _take(gr.row_ptr, lq + 1)
    pos = wc_ops.wedge_check(gr.nbr_d, gr.nbr_h, gr.nbr, lo, hi, qr["rd"],
                             qr["rh"], qr["r"])
    pos_c = pos.clamp(0, E - 1)
    # the p >= 0 test keeps the planned p word live on the wire, as in the
    # JAX package (every ok slot carries a real vertex id)
    found = (qr["ok"] & (pos < hi) & (_take(gr.nbr, pos_c) == qr["r"])
             & (qr["p"] >= 0))
    if cfg.delta:
        # fold only the three new-triangle classes: pq, pr or qr new
        found &= (qr["new2"] != 0) | _take(gr.nbr_new, pos_c)
    return TriangleBatch(
        p=qr["p"], q=qr["q"], r=qr["r"],
        vp_i=expand_lanes(qr["vp_i"], spec.vp_i),
        vq_i=_take(narrow_lanes(gr.vmeta_i, spec.vq_i), lq),
        vr_i=_take(narrow_lanes(gr.tmeta_i, spec.vr_i), pos_c),
        vp_f=expand_lanes(qr["vp_f"], spec.vp_f),
        vq_f=_take(narrow_lanes(gr.vmeta_f, spec.vq_f), lq),
        vr_f=_take(narrow_lanes(gr.tmeta_f, spec.vr_f), pos_c),
        e_pq_i=expand_lanes(qr["epq_i"], spec.e_pq_i),
        e_pr_i=expand_lanes(qr["epr_i"], spec.e_pr_i),
        e_qr_i=_take(narrow_lanes(gr.emeta_i, spec.e_qr_i), pos_c),
        e_pq_f=expand_lanes(qr["epq_f"], spec.e_pq_f),
        e_pr_f=expand_lanes(qr["epr_f"], spec.e_pr_f),
        e_qr_f=_take(narrow_lanes(gr.emeta_f, spec.e_qr_f), pos_c),
        valid=found,
    )


# ---------------------------------------------------------------------------
# hub lane (zero-exchange wedge closure against the replicated hub table)


def _hub_setup(st: dict, hub_mask: torch.Tensor) -> dict:
    """Per-shard hub-wedge streams: the inclusive cumsum of each edge's hub
    wedge count in edge order (nothing is routed), and its total."""
    cum = torch.cumsum(st["suffix"] * hub_mask.to(torch.int32), 1,
                       dtype=torch.int32)
    return dict(cum=cum, total=cum[:, -1])


def _hub_superstep(gr: ShardedDODGr, hst: dict, t: int, cfg: EngineConfig,
                   spec: MetaSpec):
    """Close one window of hub-centred wedges on the source shards: wedge
    (p; q, r) with hub centre q is looked up in the replicated row of q
    (one ``wedge_check`` launch for all S shards, over the hub table
    flattened to one key row), and meta(q), meta(r) and meta(qr) come from
    the table. Returns the [S, hub_wedge_cap] TriangleBatch and the count
    of wedges it checked. The search's positions are int32: a table of
    2³¹ keys or more raises."""
    S, E, n_loc = gr.S, gr.e_cap, gr.n_loc
    Hc, Lh = gr.hub_nbr.shape
    if Hc * Lh >= 2**31:
        raise ValueError(
            f"hub table of {Hc} rows x {Lh} keys = {Hc * Lh} keys: the hub "
            "search addresses it as one row with int32 positions, at most "
            "2**31 - 1 keys; raise hub_theta for fewer hubs")
    cap = cfg.hub_wedge_cap
    S_ax = gr.row_ptr.shape[0]
    rank = t * cap + _arange_rows(S_ax, cap, gr.device)
    ok = rank < hst["total"][:, None]
    idx = torch.searchsorted(hst["cum"], rank, right=True, out_int32=True)
    e = idx.clamp(0, E - 1)
    o = (rank - _lookup(hst["cum"], e)).clamp(0, E - 1)
    e = e.long()
    r_pos = (e + 1 + o).clamp(0, E - 1)
    p = torch.gather(gr.edge_src, 1, e)
    lp = (p // S).clamp(0, n_loc - 1)
    hid = torch.gather(gr.nbr_hub, 1, e).clamp(0, Hc - 1).long()
    lo = (hid * Lh).to(torch.int32)
    hi = lo + gr.hub_row_len[hid]
    r = torch.gather(gr.nbr, 1, r_pos)
    h_nbr = gr.hub_nbr.reshape(1, -1)
    pos = wc_ops.wedge_check(
        gr.hub_nbr_d.reshape(1, -1), gr.hub_nbr_h.reshape(1, -1), h_nbr,
        lo.reshape(1, -1), hi.reshape(1, -1),
        torch.gather(gr.nbr_d, 1, r_pos).reshape(1, -1),
        torch.gather(gr.nbr_h, 1, r_pos).reshape(1, -1),
        r.reshape(1, -1)).view(S_ax, cap)
    pos_c = pos.clamp(0, Hc * Lh - 1).long()
    found = ok & (pos < hi) & (h_nbr[0][pos_c] == r)
    if cfg.delta:
        found &= (torch.gather(gr.nbr_new, 1, e)
                  | torch.gather(gr.nbr_new, 1, r_pos)
                  | gr.hub_nbr_new.reshape(-1)[pos_c])

    def hub_rows(x, lanes):      # [Hc, Lh, k] table rows at pos
        x = narrow_lanes(x, lanes)
        return x.reshape(Hc * Lh, x.shape[-1])[pos_c]

    tri = TriangleBatch(
        p=p, q=torch.gather(gr.nbr, 1, e), r=r,
        vp_i=_take(narrow_lanes(gr.vmeta_i, spec.vp_i), lp),
        vq_i=narrow_lanes(gr.hub_vmeta_i, spec.vq_i)[hid],
        vr_i=hub_rows(gr.hub_tmeta_i, spec.vr_i),
        vp_f=_take(narrow_lanes(gr.vmeta_f, spec.vp_f), lp),
        vq_f=narrow_lanes(gr.hub_vmeta_f, spec.vq_f)[hid],
        vr_f=hub_rows(gr.hub_tmeta_f, spec.vr_f),
        e_pq_i=_take(narrow_lanes(gr.emeta_i, spec.e_pq_i), e),
        e_pr_i=_take(narrow_lanes(gr.emeta_i, spec.e_pr_i), r_pos),
        e_qr_i=hub_rows(gr.hub_eqr_i, spec.e_qr_i),
        e_pq_f=_take(narrow_lanes(gr.emeta_f, spec.e_pq_f), e),
        e_pr_f=_take(narrow_lanes(gr.emeta_f, spec.e_pr_f), r_pos),
        e_qr_f=hub_rows(gr.hub_eqr_f, spec.e_qr_f),
        valid=found,
    )
    return tri, ok.sum()


# ---------------------------------------------------------------------------
# pull lane (Sec. 4.4)


def _pull_setup(gr: ShardedDODGr, st: dict, cfg: EngineConfig, widths,
                hub_mask=None) -> dict:
    """Per-shard pull decisions + dest-major (dest, pulled, q) edge order,
    [S, ...] per field. ``st["suffix"]`` must already be masked to the
    wedges the plan generates (delta mask, hub exclusion); groups centred
    on a hub (``hub_mask``) are never pulled.

      pull        [E] bool, per edge slot (original order)
      ord2        [E] edge permutation sorted by (dest, ~pull, q, pos)
      qrank2      [E] 0-based pulled-group rank per ord2 slot
      qbase       [S] pulled-group count before each dest block
      qcount      [S] pulled groups per dest
      pulled_end  [S] ord2 index one past the pulled edges of each dest
      dest_start2 [S]
    """
    S, E = gr.S, gr.e_cap
    S_ax = gr.row_ptr.shape[0]
    dev = gr.device
    w_push, w_row, w_hdr, w_req = widths
    valid = st["valid"]
    ordq = torch.sort(torch.where(valid, gr.nbr, BIG_I32), dim=1,
                      stable=True).indices
    qs = torch.gather(gr.nbr, 1, ordq)
    sfx = torch.gather(st["suffix"], 1, ordq)
    vq = torch.gather(valid, 1, ordq)
    vq_pull = vq if hub_mask is None else vq & ~torch.gather(hub_mask, 1, ordq)
    ones = torch.ones((S_ax, 1), dtype=torch.bool, device=dev)
    first = torch.cat([ones, qs[:, 1:] != qs[:, :-1]], 1) & vq
    gid = torch.cumsum(first.to(torch.int32), 1, dtype=torch.int32) - 1
    gid = torch.where(vq, gid, E - 1).long()
    vol = torch.zeros((S_ax, E), dtype=torch.int32, device=dev).scatter_add_(
        1, gid, sfx.to(torch.int32))
    vol_e = torch.gather(vol, 1, gid)
    dq = torch.gather(gr.nbr_dplus, 1, ordq)
    if cfg.cost_model == "entries":
        pull_s = vq_pull & (dq < vol_e)
    else:
        pull_s = vq_pull & (dq * w_row + w_hdr + w_req < vol_e * w_push)
    pull = torch.zeros((S_ax, E), dtype=torch.bool, device=dev).scatter_(1, ordq, pull_s)

    # (dest, ~pull, q, pos) order: stable sort of the q-sorted order by
    # the composite bucket key
    dest_q = torch.gather(st["dest"], 1, ordq)
    bucket = torch.where(vq, dest_q * 2 + (1 - pull_s.to(torch.int32)), 2 * S + 1)
    reord = torch.sort(bucket, dim=1, stable=True).indices
    ord2 = torch.gather(ordq, 1, reord)
    qs2 = torch.gather(qs, 1, reord)
    pull2 = torch.gather(pull_s, 1, reord)
    v2 = torch.gather(vq, 1, reord)
    dest2 = torch.where(v2, torch.gather(dest_q, 1, reord), S)
    first2 = torch.cat([ones, qs2[:, 1:] != qs2[:, :-1]], 1) & v2
    cum_incl = torch.cumsum((first2 & pull2).to(torch.int32), 1, dtype=torch.int32)
    qrank2 = cum_incl - 1
    ds = torch.searchsorted(dest2, _arange_rows(S_ax, S + 1, dev), out_int32=True)
    qbase = _lookup(cum_incl, ds[:, :-1])
    qcount = _lookup(cum_incl, ds[:, 1:]) - qbase
    pcum = torch.cumsum(pull2.to(torch.int32), 1, dtype=torch.int32)
    pulled_in_dest = _lookup(pcum, ds[:, 1:]) - _lookup(pcum, ds[:, :-1])
    return dict(pull=pull, ord2=ord2, qrank2=qrank2, qbase=qbase,
                qcount=qcount, pulled_end=ds[:, :-1] + pulled_in_dest,
                dest_start2=ds[:, :-1].contiguous())


def _pull_wire(gr: ShardedDODGr, ps: dict, t: int, cfg: EngineConfig,
               spec: MetaSpec, exch: Exchange):
    """The wire half of one pull superstep: build q-requests, route them
    to the owners, answer with padded rows (declared lanes only) and route
    the reply back. Returns ``(rep, n_req)``: the fold-form reply
    ([S_req, out_cap, ...] per field) and the request count."""
    S, E, n_loc = gr.S, gr.e_cap, gr.n_loc
    dev = gr.device
    Lr = cfg.pull_row_cap if cfg.pull_row_cap else gr.d_plus_max

    # --- requester: q-requests, flat [S, out_cap] ---
    dest_of = exch.tensor("dest_of", dev)
    d = dest_of.clamp_max(S - 1).long()
    offs = t * exch.tensor("cap_of", dev) + exch.tensor("lane_of", dev)
    okq = (dest_of < S) & (offs < torch.gather(ps["qcount"], 1, d))
    k = torch.gather(ps["qbase"], 1, d) + offs
    posq = torch.searchsorted(ps["qrank2"], k, out_int32=True).clamp(0, E - 1)
    qid = _take(gr.nbr, torch.gather(ps["ord2"], 1, posq.long()))
    req = dict(q=torch.where(okq, qid, BIG_I32), ok=okq)
    req_x = exch.scatter(req)
    q, ok = req_x["q"], exch.apply_recv_ok(req_x["ok"])

    # --- owner: reply with padded rows ---
    lq = (q // S).clamp(0, n_loc - 1)
    lo = _take(gr.row_ptr, lq)
    ln = torch.where(ok, _take(gr.dplus, lq), 0)
    j = torch.arange(Lr, dtype=torch.int32, device=dev)
    slots = (lo[..., None] + j).clamp(0, E - 1)            # [S, in_cap, Lr]
    mask = j < ln[..., None]

    def rows(x, lanes):
        return _take(project_lanes(x, lanes), slots) * mask[..., None]

    rep = dict(
        r_nbr=torch.where(mask, _take(gr.nbr, slots), BIG_I32),
        r_d=torch.where(mask, _take(gr.nbr_d, slots), BIG_I32),
        r_h=torch.where(mask, _take(gr.nbr_h, slots), U32_ONES),
        r_ei=rows(gr.emeta_i, spec.e_qr_i),
        r_ef=rows(gr.emeta_f, spec.e_qr_f),
        r_ti=rows(gr.tmeta_i, spec.vr_i),
        r_tf=rows(gr.tmeta_f, spec.vr_f),
        vq_i=_take(project_lanes(gr.vmeta_i, spec.vq_i), lq),
        vq_f=_take(project_lanes(gr.vmeta_f, spec.vq_f), lq),
        ln=ln, ok=ok,
    )
    if cfg.delta:
        rep["r_new"] = mask & _take(gr.nbr_new, slots)
    rep = exch.gather(rep)
    # off the wire: re-expand shipped lanes to fold form
    rep.update(
        r_ei=expand_lanes(rep["r_ei"], spec.e_qr_i),
        r_ef=expand_lanes(rep["r_ef"], spec.e_qr_f),
        r_ti=expand_lanes(rep["r_ti"], spec.vr_i),
        r_tf=expand_lanes(rep["r_tf"], spec.vr_f),
        vq_i=expand_lanes(rep["vq_i"], spec.vq_i),
        vq_f=expand_lanes(rep["vq_f"], spec.vq_f),
    )
    return rep, req["ok"].sum()


def _pull_window(gr: ShardedDODGr, ps: dict, t: int, cfg: EngineConfig,
                 exch: Exchange, s: int):
    """Requesting shard ``s``'s pull window of superstep ``t``: its pulled
    edges that fall in this superstep (``[S_dest, pull_edge_cap]`` slots)
    and where each one's row sits in the reply. Returns ``(e, lp, ridx,
    cand_ok, overflow)``: edge slot, local pivot row, reply slot, the
    ``[S, pull_edge_cap, L]`` candidate mask, and the window overflow."""
    S, E, n_loc = gr.S, gr.e_cap, gr.n_loc
    dev = gr.device
    ecap = cfg.pull_edge_cap
    pcap = exch.tensor("caps", dev)[s]                     # [S]
    boff = exch.tensor("block_off", dev)[s]                # [S]
    qrank2, qbase = ps["qrank2"][s], ps["qbase"][s]
    lo_rank = qbase + t * pcap
    hi_rank = qbase + torch.minimum((t + 1) * pcap, ps["qcount"][s])
    lo_b, hi_b = ps["dest_start2"][s], ps["pulled_end"][s]
    estart = torch.searchsorted(qrank2, lo_rank, out_int32=True)
    eend = torch.searchsorted(qrank2, hi_rank, out_int32=True)
    estart = torch.minimum(torch.maximum(estart, lo_b), hi_b)
    eend = torch.minimum(torch.maximum(eend, lo_b), hi_b)
    j = estart[:, None] + torch.arange(ecap, dtype=torch.int32, device=dev)
    ok_e = j < eend[:, None]                                # [S, ecap]
    overflow = (eend - estart - ecap).clamp_min(0).sum()
    j_c = j.clamp(0, E - 1).long()
    e = ps["ord2"][s][j_c]                                  # original edge slot
    ok_e &= ps["pull"][s][e]
    if cfg.delta:
        # a pulled edge outside the delta_gen mask seeds no new triangle
        ok_e &= gr.delta_gen[s][e]
    slot = qrank2[j_c] - qbase[:, None] - t * pcap[:, None]
    slot = torch.minimum(slot.clamp_min(0), (pcap - 1).clamp_min(0)[:, None])
    ridx = (boff[:, None] + slot).clamp(0, exch.out_cap - 1).long()
    lp = (gr.edge_src[s][e] // S).clamp(0, n_loc - 1).long()
    row_end = gr.row_ptr[s][lp + 1]
    k = torch.arange(gr.d_plus_max, dtype=torch.int32, device=dev)
    cand_ok = ok_e[..., None] & ((e.to(torch.int32)[..., None] + 1 + k)
                                 < row_end[..., None])
    return e, lp, ridx, cand_ok, overflow


def _split_intersect(gr: ShardedDODGr, s: int, e: torch.Tensor, rp: dict,
                     L: int, Lr: int):
    """The unfused pull-lane search: gather shard ``s``'s candidate keys at
    ``clamp(e + 1 + k, 0, E - 1)`` into [B, L] arrays, pad the ``Lr``-wide
    reply rows to ``L`` with the owner's sentinels (the padding never
    crosses the wire) and lower-bound the candidates with one ``intersect``
    launch. Returns ``(pos, ci)``, both [B, L], as ``wedge_intersect``
    does."""
    k = torch.arange(L, dtype=torch.int32, device=e.device)
    r_pos = (e.to(torch.int32)[..., None] + 1 + k).clamp(0, gr.e_cap - 1).long()
    cd, ch, ci = gr.nbr_d[s][r_pos], gr.nbr_h[s][r_pos], gr.nbr[s][r_pos]

    def row(x, fill):
        x = x.reshape(-1, Lr)
        if Lr < L:
            x = torch.nn.functional.pad(x, (0, L - Lr), value=fill)
        return x

    pos = is_ops.intersect(row(rp["r_d"], BIG_I32), row(rp["r_h"], U32_ONES),
                           row(rp["r_nbr"], BIG_I32), rp["ln"].reshape(-1),
                           cd.reshape(-1, L), ch.reshape(-1, L),
                           ci.reshape(-1, L))
    return pos, ci.reshape(-1, L)


def _pull_compute(gr: ShardedDODGr, ps: dict, t: int, cfg: EngineConfig,
                  spec: MetaSpec, exch: Exchange, rep: dict, s: int):
    """The fold half of one pull superstep for requesting shard ``s``:
    intersect its local suffixes against the pulled rows ``rep`` (one
    ``wedge_intersect`` launch, or one ``intersect`` launch for
    ``pull_kernel="split"``) and emit the shard's TriangleBatch of
    ``S·pull_edge_cap·d_plus_max`` lanes. Returns ``(tri, checked,
    overflow)``."""
    S, E = gr.S, gr.e_cap
    ecap = cfg.pull_edge_cap
    L = gr.d_plus_max
    Lr = cfg.pull_row_cap if cfg.pull_row_cap else L
    e, lp, ridx, cand_ok, overflow = _pull_window(gr, ps, t, cfg, exch, s)
    rp = {key: v[s][ridx] for key, v in rep.items()}     # [S, ecap, ...]
    if cfg.pull_kernel == "split":
        pos, ci = _split_intersect(gr, s, e, rp, L, Lr)
    else:
        pos, ci = wi_ops.wedge_intersect(
            gr.nbr_d[s], gr.nbr_h[s], gr.nbr[s], e.to(torch.int32).reshape(-1),
            rp["r_d"].reshape(-1, Lr), rp["r_h"].reshape(-1, Lr),
            rp["r_nbr"].reshape(-1, Lr), rp["ln"].reshape(-1), L=L)
    pos = pos.view(S, ecap, L)
    ci = ci.view(S, ecap, L)
    pos_c = pos.clamp(0, Lr - 1).long()
    # the reply header's ok word rides back with the rows (a no-op on every
    # slot the requester's own maps admit, as in the JAX package)
    hit = (cand_ok & rp["ok"][..., None] & (pos < rp["ln"][..., None])
           & (torch.gather(rp["r_nbr"], 2, pos_c) == ci))
    del pos
    B = S * ecap * L
    kk = torch.arange(L, device=e.device)
    if cfg.delta:
        nbr_new = gr.nbr_new[s]
        hit &= (nbr_new[e][..., None]
                | nbr_new[(e[..., None] + 1 + kk).clamp(0, E - 1)]
                | torch.gather(rp["r_new"], 2, pos_c))

    def bcast(x):          # [S, ecap, ...] → [B, ...], constant over L
        tail = tuple(x.shape[2:])
        return x[:, :, None].expand((S, ecap, L) + tail).reshape((B,) + tail)

    def row_at(x):         # pulled rows [S, ecap, Lr, k] → [B, k] at pos
        k = x.shape[-1]
        return torch.gather(x, 2, pos_c[..., None].expand(-1, -1, -1, k)).reshape(B, k)

    def local(x, lanes, idx):
        return bcast(narrow_lanes(x, lanes)[s][idx])

    def suffix_at(x, lanes):   # local edge metadata at the candidate slots
        x = narrow_lanes(x, lanes)[s]
        if x.shape[-1] == 0:
            return x.new_zeros((B, 0))
        return x[(e[..., None] + 1 + kk).clamp(0, E - 1)].reshape(B, -1)

    tri = TriangleBatch(
        p=bcast(gr.edge_src[s][e]),
        q=bcast(gr.nbr[s][e]),
        r=ci.reshape(B),
        vp_i=local(gr.vmeta_i, spec.vp_i, lp),
        vq_i=bcast(rp["vq_i"]),
        vr_i=row_at(rp["r_ti"]),
        vp_f=local(gr.vmeta_f, spec.vp_f, lp),
        vq_f=bcast(rp["vq_f"]),
        vr_f=row_at(rp["r_tf"]),
        e_pq_i=local(gr.emeta_i, spec.e_pq_i, e),
        e_pr_i=suffix_at(gr.emeta_i, spec.e_pr_i),
        e_qr_i=row_at(rp["r_ei"]),
        e_pq_f=local(gr.emeta_f, spec.e_pq_f, e),
        e_pr_f=suffix_at(gr.emeta_f, spec.e_pr_f),
        e_qr_f=row_at(rp["r_ef"]),
        valid=hit.reshape(B),
    )
    return tri, cand_ok.sum(), overflow


# ---------------------------------------------------------------------------
# top level


class _F32Stats:
    """Float32 stat sums with the JAX package's rounding: every stat adds
    one exact integer per superstep, in order. Contributions stay on the
    device until :meth:`result`, so the loops never wait for the card. On
    the meta device (a dry-run trace) nothing is read back: a stat with a
    device contribution is NaN."""

    KEYS = ("wedges_pushed", "tris_push", "wedges_pulled", "tris_pull",
            "wedges_hub", "tris_hub", "pull_requests", "pull_overflow",
            "stream_dropped", "wire_push_words", "wire_req_words",
            "wire_reply_words")

    def __init__(self):
        self._parts = {k: [] for k in self.KEYS}

    def add(self, key: str, value) -> None:
        self._parts[key].append(value)

    def result(self) -> dict:
        out = {}
        for key, parts in self._parts.items():
            vals = [int(v) if isinstance(v, (int, float)) else v for v in parts]
            dev = [v for v in vals if isinstance(v, torch.Tensor)]
            stacked = torch.stack([v.to(torch.int64) for v in dev]) if dev else None
            if stacked is not None and stacked.device.type == "meta":
                out[key] = float("nan")
                continue
            host = iter(stacked.cpu().tolist() if dev else [])
            acc = np.float32(0.0)
            for v in vals:
                x = next(host) if isinstance(v, torch.Tensor) else v
                acc = np.float32(acc + np.float32(x))
            out[key] = float(acc)
        return out


def _survey_body(gr: ShardedDODGr, survey: Survey, cfg: EngineConfig,
                 spec: MetaSpec, push_exch: Exchange,
                 pull_exch: Exchange | None):
    """The superstep pipeline, shared by both lowerings: on the stacked
    layout ``gr`` carries all S shards ([S, ...] tensors, host-modelled
    transports); on a mesh rank it is the rank's shard ([1, ...] tensors,
    a :class:`~repro_torch.comm.mesh_exchange.LocalMeshView` per lane).
    Returns the per-shard states (a list, one per leading row) and the
    stats of those rows."""
    S_ax = gr.row_ptr.shape[0]    # leading axis: S stacked, 1 on a rank
    dev = gr.device
    states = [survey.init(dev) for _ in range(S_ax)]

    mw = cfg.meta_widths
    if mw is None:
        mw = meta_widths(*spec.lane_counts())
        if cfg.delta:   # newness bits on the wire (as plan_engine counts them)
            mw = (mw[0] + 1, mw[1] + 1, mw[2], mw[3])
    w_push, w_row, w_hdr, w_req = mw

    hub_on = cfg.n_hub_steps > 0 and gr.n_hubs > 0
    is_hub = (gr.nbr_hub >= 0) if hub_on else None
    gen = gr.delta_gen if cfg.delta else None

    stats = _F32Stats()
    push_caps = push_exch.tensor("caps", dev)
    if cfg.mode == "pushpull":
        st0 = _stream_setup(gr)
        sfx = st0["suffix"]
        if cfg.delta:
            # pull decisions weigh only the wedges the delta mask generates
            sfx = sfx * gen
        if hub_on:
            # hub-centred groups carry no pullable volume
            sfx = sfx * ~is_hub
        ps = _pull_setup(gr, dict(st0, suffix=sfx), cfg, mw, hub_mask=is_hub)
        push_mask = ~ps["pull"]
        if cfg.delta:
            push_mask &= gen
        if hub_on:
            push_mask &= ~is_hub
        st = _stream_setup(gr, weight_mask=push_mask)
        pull_caps = pull_exch.tensor("caps", dev)
        stats.add("stream_dropped",
                  (ps["qcount"] - cfg.n_pull_steps * pull_caps).clamp_min(0).sum())
    else:
        ps = None
        wm = gen
        if hub_on:
            wm = ~is_hub if gen is None else gen & ~is_hub
        st = _stream_setup(gr, weight_mask=wm)
    stats.add("stream_dropped",
              (st["stream_len"] - cfg.n_push_steps * push_caps).clamp_min(0).sum())
    if hub_on:
        hst = _hub_setup(st, is_hub if gen is None else is_hub & gen)
        stats.add("stream_dropped",
                  (hst["total"] - cfg.n_hub_steps * cfg.hub_wedge_cap).clamp_min(0).sum())

    push_step_words = push_exch.round_slots() * w_push
    for t in range(cfg.n_push_steps):
        qr = _gen_push_queries(gr, st, t, push_exch, spec, delta=cfg.delta)
        n_gen = qr["ok"].sum()
        qx = push_exch.scatter(qr)
        qx["ok"] = push_exch.apply_recv_ok(qx["ok"])
        tri = _answer_push_queries(gr, qx, cfg, spec)
        for s in range(S_ax):
            states[s] = survey.update(states[s], tri.shard(s))
        stats.add("wedges_pushed", n_gen)
        stats.add("tris_push", tri.valid.sum())
        stats.add("wire_push_words", push_step_words)

    for t in range(cfg.n_hub_steps if hub_on else 0):
        tri, n_w = _hub_superstep(gr, hst, t, cfg, spec)
        for s in range(S_ax):
            states[s] = survey.update(states[s], tri.shard(s))
        stats.add("wedges_hub", n_w)
        stats.add("tris_hub", tri.valid.sum())
        del tri

    if cfg.mode == "pushpull" and cfg.n_pull_steps > 0:
        Lr = cfg.pull_row_cap if cfg.pull_row_cap else gr.d_plus_max
        req_step_words = pull_exch.round_slots() * w_req
        reply_step_words = pull_exch.round_slots() * (w_hdr + Lr * w_row)
        for t in range(cfg.n_pull_steps):
            rep, n_req = _pull_wire(gr, ps, t, cfg, spec, pull_exch)
            checked = tris = overflow = 0
            for s in range(S_ax):
                tri, c_s, o_s = _pull_compute(gr, ps, t, cfg, spec,
                                              pull_exch, rep, s)
                states[s] = survey.update(states[s], tri)
                checked = checked + c_s
                tris = tris + tri.valid.sum()
                overflow = overflow + o_s
                del tri
            stats.add("wedges_pulled", checked)
            stats.add("tris_pull", tris)
            stats.add("pull_requests", n_req)
            stats.add("pull_overflow", overflow)
            stats.add("wire_req_words", req_step_words)
            stats.add("wire_reply_words", reply_step_words)

    return states, stats.result()


def stack_states(states: list):
    """Per-shard states → one state of [S, ...] tensors, of the same
    structure: a tensor, a dict or a tuple of states (a bundle's)."""
    return tree_map(lambda *xs: torch.stack(xs), *states)


# per-step wire-words stats: every rank accumulates the same value, so the
# mesh lowering keeps one rank's copy instead of summing over ranks
_WIRE_STAT_KEYS = ("wire_push_words", "wire_req_words", "wire_reply_words")


def _gather_states(mesh, state) -> list:
    """Every rank's survey state, in rank order, on this rank's device:
    one all-gather of the state's bytes (the states have one shape on
    every rank)."""
    leaves = []
    tree_map(lambda x: leaves.append(x.contiguous()), state)
    buf = torch.cat([x.reshape(-1).view(torch.uint8) for x in leaves])
    out = []
    for b in mesh.all_gather(buf):
        parts, off = [], 0
        for x in leaves:
            n = x.numel() * x.element_size()
            parts.append(b[off:off + n].clone().view(x.dtype).reshape(x.shape))
            off += n
        it = iter(parts)
        out.append(tree_map(lambda _: next(it), state))
    return out


def _sum_rank_stats(mesh, stats: dict) -> dict:
    """The mesh lowering's stats, as the JAX package forms them: each
    rank's float32 sums, added in float32 in rank order; the wire-words
    stats from one rank."""
    keys = list(stats)
    vals = torch.tensor([stats[k] for k in keys], dtype=torch.float32,
                        device=mesh.device)
    per_rank = [v.cpu().numpy() for v in mesh.all_gather(vals)]
    out = {}
    for i, k in enumerate(keys):
        if k in _WIRE_STAT_KEYS:
            out[k] = float(per_rank[0][i])
            continue
        acc = np.float32(0.0)
        for v in per_rank:
            acc = np.float32(acc + v[i])
        out[k] = float(acc)
    return out


def make_survey_fn(survey: Survey, cfg: EngineConfig, mesh=None):
    """Build the survey function ``gr -> (merged_state, stats)``. ``stats``
    are Python floats holding the float32 sums.

    ``mesh=None`` is the stacked lowering: all S shards on one device,
    transports modelled by reshapes and gathers. A ``launch.mesh.ShardMesh``
    (``make_shard_mesh(S)``, inside each of S ``torch.distributed``
    ranks) runs the same superstep body on the rank's shard, every
    ``scatter`` / ``gather`` a real collective
    (:mod:`repro_torch.comm.mesh_exchange`), hub tables replicated. The
    function takes the whole stacked graph (the rank takes its slice) or
    the rank's slice (``dodgr.shard_slice``). Each rank's state is
    all-gathered and merged in rank order, so every rank returns the
    stacked lowering's merged state bit for bit; the stats follow the
    JAX package's mesh rule (per-rank float32 sums added in rank order),
    equal to the stacked stats while every sum stays below 2²⁴.
    """
    if mesh is None:
        if cfg.transport == "mesh":
            raise ValueError(
                "a transport='mesh' plan runs real collectives — pass "
                "mesh=launch.make_shard_mesh(S) to make_survey_fn / the "
                "survey entry points, or re-plan with transport='dense' or "
                "'ragged' for the stacked path")

        def run(gr: ShardedDODGr):
            spec = resolve_survey_spec(survey, gr, cfg)
            push_exch = _push_exchange(cfg, gr.S)
            pull_exch = (_pull_exchange(cfg, gr.S)
                         if cfg.mode == "pushpull" else None)
            states, stats = _survey_body(gr, survey, cfg, spec, push_exch,
                                         pull_exch)
            return survey.merge(stack_states(states)), stats

        return run

    def run(gr: ShardedDODGr):
        if mesh.size != gr.S:
            raise ValueError(
                f"mesh has {mesh.size} rank(s) but the graph has S={gr.S} "
                "shards; build it with launch.make_shard_mesh(S)")
        rows = gr.row_ptr.shape[0]
        if rows == gr.S:
            gr = shard_slice(gr, mesh.rank, device=mesh.device)
        elif rows != 1:
            raise ValueError(f"a graph of {rows} shard rows is neither the "
                             f"whole stack of S={gr.S} nor one rank's slice")
        spec = resolve_survey_spec(survey, gr, cfg)
        push_exch = make_exchange("mesh", gr.S, cfg.push_cap, cfg.push_caps,
                                  mesh=mesh, lanes=("push", "push_back"))
        pull_exch = (make_exchange("mesh", gr.S, cfg.pull_q_cap,
                                   cfg.pull_caps, mesh=mesh,
                                   lanes=("req", "reply"))
                     if cfg.mode == "pushpull" else None)
        states, stats = _survey_body(
            gr, survey, cfg, spec, push_exch.local_view(mesh.rank),
            pull_exch.local_view(mesh.rank) if pull_exch else None)
        merged = survey.merge(stack_states(_gather_states(mesh, states[0])))
        return merged, _sum_rank_stats(mesh, stats)

    return run


def resolve_survey_spec(survey: Survey, gr: ShardedDODGr,
                        cfg: EngineConfig | None = None) -> MetaSpec:
    """Concretize the survey's declared lanes against the graph's storage
    widths. ``cfg.project_meta=False`` forces the full-metadata spec."""
    dvi, dvf = gr.vmeta_i.shape[-1], gr.vmeta_f.shape[-1]
    dei, def_ = gr.emeta_i.shape[-1], gr.emeta_f.shape[-1]
    spec = getattr(survey, "meta_spec", None)
    if spec is None or (cfg is not None and not cfg.project_meta):
        spec = MetaSpec.full()
    return spec.resolve(dvi, dvf, dei, def_)


def _exactness_guard(cfg: EngineConfig, stats: dict) -> dict:
    """A static window that overflowed means triangles were dropped: flag
    the run inexact, and say so."""
    lost = stats.get("pull_overflow", 0.0) + stats.get("stream_dropped", 0.0)
    stats["exact"] = lost == 0.0
    if lost > 0:
        msg = (
            f"survey result is INEXACT: {int(stats.get('pull_overflow', 0))} "
            f"pull-window candidate(s) and "
            f"{int(stats.get('stream_dropped', 0))} stream slot(s) overflowed "
            "their static capacities and were dropped, so triangles are "
            "undercounted. Use the capacities planned by "
            "pushpull.plan_engine/plan_delta (they size every window "
            "exactly), or pass on_overflow='raise' to fail fast.")
        if cfg.on_overflow == "raise":
            raise RuntimeError(msg)
        warnings.warn(msg, RuntimeWarning, stacklevel=3)
    return stats


def _finalize_run(survey: Survey, cfg: EngineConfig, merged, stats: dict):
    """Host-side epilogue: per-survey stats, exactness guard, DOULION
    debiasing and its variance estimate."""
    stats = {k: float(v) for k, v in stats.items()}
    members = getattr(survey, "surveys", (survey,))
    stats["n_surveys"] = float(len(members))
    stats = _exactness_guard(cfg, stats)
    result = survey.finalize(merged)
    if cfg.sample_p < 1.0:
        p = cfg.sample_p
        result = survey.scale_sampled(result, p)
        raw = stats["tris_push"] + stats["tris_pull"] + stats["tris_hub"]
        est = raw / p**3
        var = est * (1.0 / p**3 - 1.0)
        stats["sample_p"] = p
        stats["sample_scale"] = 1.0 / p**3
        stats["sample_variance"] = var
        stats["sample_rel_stderr"] = float(np.sqrt(var) / max(est, 1.0))
    return result, stats


def _check_sampling(gr: ShardedDODGr, cfg: EngineConfig) -> list[str]:
    g_key = (gr.sample_p, gr.sample_seed)
    c_key = (cfg.sample_p, cfg.sample_seed)
    if gr.sample_p == cfg.sample_p == 1.0:
        return []
    if g_key != c_key:
        return [
            f"sampling mismatch: graph ingested with (p, seed)={g_key} but "
            f"plan built with {c_key}; pass the same sample_p/sample_seed "
            "to shard_dodgr and plan_engine"]
    return []


def _check_provenance(gr: ShardedDODGr, cfg: EngineConfig):
    """Graph stamps and plan stamps must agree — sampling, orientation
    key, hub threshold, epoch/delta state — or results are silently wrong.
    Reports every diverged field at once."""
    diffs = _check_sampling(gr, cfg)
    if gr.is_delta != cfg.delta:
        what = "a delta frontier" if gr.is_delta else "a full snapshot"
        want = "survey_delta with a plan_delta plan" if gr.is_delta \
            else "survey_push_only/survey_push_pull with a plan_engine plan"
        diffs.append(
            f"delta mismatch: graph is {what} (is_delta={gr.is_delta}) but "
            f"the plan stamps delta={cfg.delta}; run it through {want}")
    if gr.orient != cfg.orient:
        diffs.append(
            f"orientation mismatch: graph sharded with orient={gr.orient!r} "
            f"but plan built with orient={cfg.orient!r}")
    if gr.hub_theta != cfg.hub_theta:
        diffs.append(
            f"hub mismatch: graph sharded with hub_theta={gr.hub_theta} but "
            f"plan built with hub_theta={cfg.hub_theta}; pass the planner's "
            "θ (cfg.hub_theta) to shard_dodgr/shard_delta")
    if cfg.delta and gr.is_delta and gr.epoch != cfg.epoch:
        diffs.append(
            f"epoch mismatch: frontier is epoch {gr.epoch} but the plan was "
            f"built for epoch {cfg.epoch}; re-plan each appended batch")
    if diffs:
        raise ValueError(
            "graph/plan provenance diverged on "
            f"{len(diffs)} field(s):\n  - " + "\n  - ".join(diffs))


def survey_push_only(gr: ShardedDODGr, survey: Survey, cfg: EngineConfig,
                     mesh=None):
    _check_provenance(gr, cfg)
    cfg = replace(cfg, mode="push")
    merged, stats = make_survey_fn(survey, cfg, mesh=mesh)(gr)
    return _finalize_run(survey, cfg, merged, stats)


def survey_push_pull(gr: ShardedDODGr, survey: Survey, cfg: EngineConfig,
                     mesh=None):
    _check_provenance(gr, cfg)
    cfg = replace(cfg, mode="pushpull")
    merged, stats = make_survey_fn(survey, cfg, mesh=mesh)(gr)
    return _finalize_run(survey, cfg, merged, stats)


def survey_with_fn(gr: ShardedDODGr, survey: Survey, cfg: EngineConfig, fn):
    """Run a prebuilt survey function (``make_survey_fn(survey, cfg)``, or
    a wrapper of it) through the same provenance check and host epilogue
    as the one-shot entry points: the serving fast path, where a plan-cache
    hit replays the cached function on the cached shards without planning
    or sharding again. The caller pairs ``fn`` with the ``(survey, cfg)``
    it was built from; ``gr`` is still checked against ``cfg``."""
    _check_provenance(gr, cfg)
    merged, stats = fn(gr)
    return _finalize_run(survey, cfg, merged, stats)


# ---------------------------------------------------------------------------
# epoch-incremental entry point (delta engine)


def survey_delta(gr: ShardedDODGr, survey: Survey, cfg: EngineConfig,
                 prev_state=None, mesh=None):
    """One incremental epoch: traverse the delta frontier ``gr``, folding
    only the triangles with an edge of this epoch's batch, then accumulate
    into ``prev_state`` through the survey's ``merge_epochs``.

    ``cfg`` comes from ``pushpull.plan_delta`` for the same epoch
    (provenance is checked). Returns ``(state, stats)``: the merged, not
    finalized, accumulator, to pass back as ``prev_state`` next epoch and
    to render with :func:`finalize_epochs`. After K epochs the rendering
    equals one survey of the union, bit for bit, for every built-in.
    """
    if not cfg.delta:
        raise ValueError("survey_delta needs a delta plan — build cfg with "
                         "pushpull.plan_delta(dg, S, survey, ...)")
    if cfg.sample_p < 1.0:
        raise ValueError("DOULION sampling is not supported on delta epochs; "
                         "sample the full snapshot instead")
    _check_provenance(gr, cfg)
    if prev_state is not None and cfg.determinism == "order_sensitive":
        warnings.warn(
            "survey_delta: the plan's survey was classified "
            "order_sensitive by the determinism stamp "
            "(repro_torch.analysis.contracts) — accumulating it through "
            "merge_epochs holds the incremental == recompute identity only "
            "up to float reduction order, not bitwise.",
            RuntimeWarning, stacklevel=2)
    merged, stats = make_survey_fn(survey, cfg, mesh=mesh)(gr)
    stats["epoch"] = float(cfg.epoch)
    stats["n_surveys"] = float(len(getattr(survey, "surveys", (survey,))))
    stats = _exactness_guard(cfg, stats)
    if prev_state is not None:
        merged = survey.merge_epochs(prev_state, merged)
    return merged, stats


def finalize_epochs(survey: Survey, state):
    """Render an epoch accumulator (from :func:`survey_delta`) on the host —
    the delta engine's counterpart of the one-shot finalize."""
    return survey.finalize(state)
