"""Plan/exchange conservation checker (pass 2 of ``repro_torch.analysis``).

Every quantity the engine ships across the shard axis is determined *on
host, before the first superstep*: the planner stamps per-lane capacities
and superstep counts into :class:`~repro_torch.core.engine.EngineConfig`,
the transport builds static index maps from them, and the
:class:`~repro_torch.core.pushpull.VolumeReport` claims analytic wire
volumes that the engine's measured buffers must match byte for byte. That
makes the whole communication structure *provable without moving a byte*
— this module does exactly that, with plain numpy over the static maps of
the port's transports (``comm/exchange.py``, ``comm/mesh_exchange.py``,
``comm/round_schedule.py``), as the JAX package's
``repro.analysis.conservation`` does over its own, with the same codes:

* :func:`check_exchange` — the send maps (``dest_of``/``lane_of``/
  ``block_off``) address the wire buffer injectively, every sent slot has
  exactly one recv slot (via ``in_off``), ``recv_ok`` covers precisely the
  fed slots (no masked deliveries, no phantom reads), and per-pair caps
  conserve slot counts end to end.
* :func:`check_schedule` — a mesh :class:`~repro_torch.comm.
  round_schedule.RoundSchedule` covers every off-diagonal cap exactly
  once in rounds that are partial permutations.
* :func:`check_plan` — the stamped config and the report reconcile
  word-for-word: projected ``meta_widths`` against the report's entry
  widths, per-lane slot totals against the transports actually built from
  the config, analytic ``wire_*_bytes`` recomputed from
  steps × slots × width, and superstep counts × capacities actually cover
  the planner's measured stream maxima, so a plan that would drop wedges
  is rejected at plan time. A ``cap_policy`` pass then proves a bucketed
  plan is "the same plan, rounded up": every shape knob sits on the
  bucket grid, the stamped exact shadow lane reconciles word-for-word
  and *still covers every fed slot* (bucketing never hides a
  truncation), and ``bucket_pad_bytes`` is exactly the wire-byte
  difference between the two lanes.

Zero device execution: everything here is host numpy on static arrays.
"""
from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np

from repro_torch.analysis.report import Violation
from repro_torch.comm.exchange import Exchange, make_exchange
from repro_torch.utils import bucket_cap

if TYPE_CHECKING:  # types only: core.pushpull imports analysis.contracts
    from repro_torch.core.engine import EngineConfig
    from repro_torch.core.pushpull import VolumeReport


def check_exchange(exch: Exchange, lane: str = "push") -> list[Violation]:
    """Statically verify one transport's routing maps.

    ``lane`` only labels the findings (``push`` / ``pull``)."""
    v: list[Violation] = []

    def bad(code: str, where: str, msg: str) -> None:
        v.append(Violation("conservation", code, where, msg))

    S = int(exch.S)
    caps = np.asarray(exch.caps, np.int64)
    if caps.shape != (S, S):
        bad("caps-shape", f"{lane}", f"caps is {caps.shape}, expected "
            f"({S}, {S}) — one per-round capacity per (src, dest) pair")
        return v
    if (caps < 0).any():
        s, d = map(int, np.argwhere(caps < 0)[0])
        bad("caps-negative", f"{lane}:({s}->{d})",
            f"negative per-pair capacity {int(caps[s, d])}")
        return v

    dest_of = np.asarray(exch.dest_of, np.int64)
    lane_of = np.asarray(exch.lane_of, np.int64)
    cap_of = np.asarray(exch.cap_of, np.int64)
    block_off = np.asarray(exch.block_off, np.int64)
    in_off = np.asarray(exch.in_off, np.int64)
    out_cap, in_cap = int(exch.out_cap), int(exch.in_cap)

    # --- send side: maps address the wire buffer injectively ---
    claimed = np.zeros((S, in_cap), np.int64)   # sent slots per recv slot
    for s in range(S):
        valid = dest_of[s] < S                  # dest_of == S marks padding
        n_valid, n_caps = int(valid.sum()), int(caps[s].sum())
        if n_valid != n_caps:
            bad("send-cap-conservation", f"{lane}:src{s}",
                f"send map exposes {n_valid} routable slots but caps[{s}, :] "
                f"sums to {n_caps} — entries would be {'dropped' if n_valid < n_caps else 'fabricated'} on the wire")
            continue
        j = np.nonzero(valid)[0]
        d, ln, c = dest_of[s][valid], lane_of[s][valid], cap_of[s][valid]
        if (ln < 0).any() or (ln >= c).any():
            k = int(j[(ln < 0) | (ln >= c)][0])
            bad("send-lane-overflow", f"{lane}:src{s}:slot{k}",
                f"lane_of[{s}, {k}] = {int(lane_of[s, k])} outside its block "
                f"capacity {int(cap_of[s, k])}")
            continue
        if (c != caps[s, d]).any():
            k = int(j[c != caps[s, d]][0])
            bad("send-cap-mismatch", f"{lane}:src{s}:slot{k}",
                f"cap_of[{s}, {k}] = {int(cap_of[s, k])} disagrees with "
                f"caps[{s}, {int(dest_of[s, k])}] = "
                f"{int(caps[s, dest_of[s, k]])}")
            continue
        if (j != block_off[s, d] + ln).any():
            k = int(j[j != block_off[s, d] + ln][0])
            bad("aliased-send-offsets", f"{lane}:src{s}:slot{k}",
                f"slot {k} routes to (dest {int(dest_of[s, k])}, lane "
                f"{int(lane_of[s, k])}) but block_off + lane addresses slot "
                f"{int(block_off[s, dest_of[s, k]] + lane_of[s, k])} — the "
                "send map does not invert the block layout, so two entries "
                "would collide in one wire slot")
            continue
        pair = d * np.int64(out_cap) + ln
        if len(np.unique(pair)) != len(pair):
            bad("send-map-not-injective", f"{lane}:src{s}",
                "two send slots map to the same (dest, lane) — one entry "
                "silently overwrites the other on delivery")
            continue
        # --- recv side: where swapping/gather actually lands each slot ---
        r = in_off[d, s] + ln
        if (r < 0).any() or (r >= in_cap).any():
            k = int(j[(r < 0) | (r >= in_cap)][0])
            bad("recv-slot-oob", f"{lane}:src{s}:slot{k}",
                f"slot {k} (dest {int(dest_of[s, k])}) lands at recv "
                f"position {int(in_off[dest_of[s, k], s] + lane_of[s, k])} "
                f"outside the recv buffer (in_cap={in_cap})")
            continue
        np.add.at(claimed, (d, r), 1)

    if (claimed > 1).any():
        d, r = map(int, np.argwhere(claimed > 1)[0])
        bad("recv-slot-aliased", f"{lane}:dest{d}:recv{r}",
            f"{int(claimed[d, r])} sent slots are delivered to the same "
            f"recv slot {r} of shard {d} — deliveries overwrite each other")

    ok = (np.ones((S, in_cap), bool) if exch.recv_ok is None
          else np.asarray(exch.recv_ok, bool))
    fed = claimed.astype(bool)
    if (fed & ~ok).any():
        d, r = map(int, np.argwhere(fed & ~ok)[0])
        bad("recv-ok-missing", f"{lane}:dest{d}:recv{r}",
            f"recv slot {r} of shard {d} receives a sent entry but recv_ok "
            "masks it invalid — delivered work would be dropped")
    if (ok & ~fed).any() and exch.recv_ok is not None:
        d, r = map(int, np.argwhere(ok & ~fed)[0])
        bad("recv-ok-phantom", f"{lane}:dest{d}:recv{r}",
            f"recv_ok marks slot {r} of shard {d} valid but no sender feeds "
            "it — the fold would consume stale buffer contents")

    total = int(caps.sum())
    if exch.round_slots() != total:
        bad("round-slot-total", lane,
            f"round_slots() = {exch.round_slots()} but per-pair caps sum to "
            f"{total}")
    return v


def check_schedule(schedule, caps, lane: str = "push") -> list[Violation]:
    """Statically verify a mesh :class:`~repro_torch.comm.round_schedule.
    RoundSchedule` against its cap matrix.

    Proves, with plain host arithmetic: every off-diagonal (src, dest) cap
    is covered *exactly once* across the wire rounds (contiguous slices,
    no gaps, no overlaps — no slot aliasing on the recv compaction); every
    round is a valid partial permutation (each device sends at most once
    and receives at most once per round: one ``batch_isend_irecv``);
    every round's padded slot count equals its longest part; the self
    diagonal is fully carried by the local (no-wire) parts; and the
    schedule's slot totals are self-consistent (``wire_slots`` == Σ round
    slots)."""
    v: list[Violation] = []

    def bad(code: str, where: str, msg: str) -> None:
        v.append(Violation("conservation", code, where, msg))

    caps = np.asarray(caps, np.int64)
    S = int(schedule.S)
    if caps.shape != (S, S):
        bad("sched-caps-shape", lane,
            f"schedule is for S={S} but caps is {caps.shape}")
        return v

    segs: dict[tuple[int, int], list[tuple[int, int]]] = {}
    for i, rnd in enumerate(schedule.wire_rounds):
        if not rnd.parts:
            bad("sched-empty-round", f"{lane}:round{i}",
                "round ships no parts — a pure-padding collective")
            continue
        if rnd.slots != max(p.length for p in rnd.parts):
            bad("sched-round-slots", f"{lane}:round{i}",
                f"round pads to {rnd.slots} slots but its longest part is "
                f"{max(p.length for p in rnd.parts)}")
        srcs = [p.src for p in rnd.parts]
        dsts = [p.dest for p in rnd.parts]
        if len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts):
            bad("sched-not-permutation", f"{lane}:round{i}",
                "two parts share a source or destination device — one "
                "ppermute cannot ship both")
        for p in rnd.parts:
            if p.src == p.dest:
                bad("sched-diagonal-on-wire", f"{lane}:round{i}",
                    f"part ({p.src}->{p.dest}) puts the resident self "
                    "diagonal on the wire")
            if p.length < 1 or p.length > rnd.slots:
                bad("sched-part-length", f"{lane}:round{i}:({p.src}->"
                    f"{p.dest})", f"part length {p.length} outside "
                    f"(0, {rnd.slots}]")
            segs.setdefault((p.src, p.dest), []).append(
                (p.lane_lo, p.lane_lo + p.length))

    # exact cover of every off-diagonal cap: sorted slices tile [0, cap)
    for s in range(S):
        for d in range(S):
            if s == d:
                continue
            want = int(caps[s, d])
            got = sorted(segs.pop((s, d), []))
            lo = 0
            for a, b in got:
                if a != lo:
                    bad("sched-cover", f"{lane}:({s}->{d})",
                        f"chunk lanes [{lo}, {a}) are "
                        f"{'re-shipped' if a < lo else 'never shipped'} — "
                        "slices must tile the chunk exactly once")
                    break
                lo = b
            else:
                if lo != want:
                    bad("sched-cover", f"{lane}:({s}->{d})",
                        f"slices cover lanes [0, {lo}) of a {want}-slot "
                        "chunk")
    for (s, d) in segs:
        bad("sched-cover", f"{lane}:({s}->{d})",
            "schedule ships a pair with zero capacity")

    loc = {(p.src, p.length) for p in schedule.local_parts}
    diag = {(s, int(caps[s, s])) for s in range(S) if caps[s, s] > 0}
    if loc != diag:
        bad("sched-local-cover", lane,
            f"local (self-diagonal) parts {sorted(loc)} do not match the "
            f"cap diagonal {sorted(diag)}")

    if schedule.wire_slots != sum(r.slots for r in schedule.wire_rounds):
        bad("sched-slot-total", lane,
            f"wire_slots={schedule.wire_slots} but rounds sum to "
            f"{sum(r.slots for r in schedule.wire_rounds)}")
    return v


def _coverage(code: str, lane: str, steps: int, per_round: int,
              need: int, what: str, v: list[Violation]) -> None:
    have = steps * per_round
    if need > have:
        v.append(Violation(
            "conservation", code, lane,
            f"plan covers {steps} superstep(s) × {per_round} {what}/round "
            f"= {have}, but the planner measured a peak stream of {need} — "
            f"{need - have} would be truncated at runtime. Raise the cap or "
            "step count (plan_engine sizes these from the same histograms, "
            "so a stamped plan violating this was built or edited by hand)"))


def check_plan(cfg: "EngineConfig", report: "VolumeReport") -> list[Violation]:
    """Reconcile a stamped plan against its :class:`VolumeReport`,
    word-for-word, and verify the transports it will instantiate."""
    v: list[Violation] = []

    def bad(code: str, where: str, msg: str) -> None:
        v.append(Violation("conservation", code, where, msg))

    S = int(report.S)
    if cfg.transport != report.transport:
        bad("transport-mismatch", "plan",
            f"config stamps transport={cfg.transport!r} but the report was "
            f"accounted for {report.transport!r}")
        return v

    # --- widths: the stamped plan and the report must agree per word ---
    if cfg.meta_widths is None:
        bad("meta-widths-unstamped", "plan",
            "EngineConfig.meta_widths is None — plan_engine always stamps "
            "the projected (w_push, w_row, w_hdr, w_req); a hand-built "
            "config cannot be byte-audited")
        return v
    w_push, w_row, w_hdr, w_req = cfg.meta_widths
    rep_w = (report.push_entry_width, report.pull_row_width,
             report.pull_header_width, report.request_width)
    for name, cw, rw in zip(("w_push", "w_row", "w_hdr", "w_req"),
                            cfg.meta_widths, rep_w):
        if cw != rw:
            bad("width-mismatch", f"plan:{name}",
                f"config stamps {name}={cw} words but the report accounted "
                f"{rw} — bytes on the wire would not match the audit")
    if cfg.pull_row_cap != report.pull_row_cap:
        bad("pull-row-cap-mismatch", "plan",
            f"config stamps pull_row_cap={cfg.pull_row_cap} but the report "
            f"accounted {report.pull_row_cap} reply rows")

    # a mesh transport executes a RoundSchedule: prove it covers the caps
    # exactly, and that the report's stamped schedule summary matches the
    # (deterministically recomputed) schedule the transport will run
    def audit_schedule(exch, lane, stamped, naive_stamped):
        sc, naive = exch.schedule, exch.naive_schedule
        v.extend(check_schedule(sc, exch.caps, lane))
        covered = (sum(p.length for r in sc.wire_rounds for p in r.parts)
                   + sum(p.length for p in sc.local_parts))
        logical = int(np.asarray(exch.caps, np.int64).sum())
        if covered != logical:
            bad("sched-wire-words", lane,
                f"schedule covers {covered} slots but the lane's logical "
                f"wire words (Σ caps) are {logical}")
        if stamped != (sc.n_rounds, sc.wire_slots):
            bad("sched-report-mismatch", lane,
                f"report stamps scheduled (rounds, slots)={stamped} but the "
                f"transport's schedule is ({sc.n_rounds}, {sc.wire_slots})")
        if naive_stamped != (naive.n_rounds, naive.wire_slots):
            bad("sched-report-mismatch", f"{lane}:naive",
                f"report stamps naive (rounds, slots)={naive_stamped} but "
                f"the rotation schedule is "
                f"({naive.n_rounds}, {naive.wire_slots})")
        if sc.wire_slots > naive.wire_slots:
            bad("sched-worse-than-naive", lane,
                f"scheduled wire slots {sc.wire_slots} exceed the naive "
                f"rotation's {naive.wire_slots} — the scheduler must never "
                "regress the padded slot total")

    # --- push lane: build the actual transport and audit it ---
    try:
        push_x = make_exchange(cfg.transport, S, cfg.push_cap, cfg.push_caps)
    except Exception as e:
        bad("push-exchange-invalid", "push",
            f"config's push-lane capacities do not build a transport: {e}")
        return v
    v += check_exchange(push_x, "push")
    if cfg.transport == "mesh":
        audit_schedule(push_x, "push",
                       (report.sched_push_rounds, report.sched_push_slots),
                       (report.naive_push_rounds, report.naive_push_slots))
    push_slots = push_x.round_slots()
    if push_slots != report.wire_push_slots_step:
        bad("wire-slot-total", "push",
            f"push transport ships {push_slots} slots/round but the report "
            f"claims wire_push_slots_step={report.wire_push_slots_step}")
    want = cfg.n_push_steps * push_slots * w_push * 4
    if want != report.wire_push_bytes:
        bad("wire-bytes-push", "push",
            f"n_push_steps({cfg.n_push_steps}) × slots({push_slots}) × "
            f"w_push({w_push}) × 4 = {want} B but the report claims "
            f"wire_push_bytes={report.wire_push_bytes}")
    _coverage("plan-truncation-push", "push", cfg.n_push_steps,
              int(np.asarray(push_x.caps, np.int64).max()),
              report.push_stream_max, "slots per heaviest (src,dest) pair",
              v)
    entries_need = (report.pushpull_push_entries if cfg.mode == "pushpull"
                    else report.push_only_entries)
    _coverage("plan-truncation-push", "push:total", cfg.n_push_steps,
              push_slots, entries_need, "wire slots", v)

    # --- pull lane ---
    if cfg.n_pull_steps:
        try:
            pull_x = make_exchange(cfg.transport, S, cfg.pull_q_cap,
                                   cfg.pull_caps)
        except Exception as e:
            bad("pull-exchange-invalid", "pull",
                f"config's pull-lane capacities do not build a transport: "
                f"{e}")
            return v
        v += check_exchange(pull_x, "pull")
        if cfg.transport == "mesh":
            audit_schedule(pull_x, "pull",
                           (report.sched_req_rounds, report.sched_req_slots),
                           (report.naive_req_rounds, report.naive_req_slots))
        req_slots = pull_x.round_slots()
        if req_slots != report.wire_req_slots_step:
            bad("wire-slot-total", "pull",
                f"pull transport ships {req_slots} request slots/round but "
                f"the report claims "
                f"wire_req_slots_step={report.wire_req_slots_step}")
        _coverage("plan-truncation-pull", "pull", cfg.n_pull_steps,
                  int(np.asarray(pull_x.caps, np.int64).max()),
                  report.pull_groups_max,
                  "pulled groups per heaviest (src,dest) pair", v)
        _coverage("plan-truncation-pull", "pull:total", cfg.n_pull_steps,
                  req_slots, report.pushpull_requests, "request slots", v)
    else:
        req_slots = 0
        if report.wire_req_slots_step != 0:
            bad("wire-slot-total", "pull",
                f"plan runs zero pull supersteps but the report claims "
                f"wire_req_slots_step={report.wire_req_slots_step}")
        if cfg.mode == "pushpull" and report.pushpull_requests > 0:
            bad("plan-truncation-pull", "pull",
                f"the planner measured {report.pushpull_requests} pulled "
                "groups but the plan runs zero pull supersteps — every pull "
                "would be dropped")
    want = cfg.n_pull_steps * req_slots * w_req * 4
    if want != report.wire_req_bytes:
        bad("wire-bytes-req", "pull",
            f"n_pull_steps({cfg.n_pull_steps}) × slots({req_slots}) × "
            f"w_req({w_req}) × 4 = {want} B but the report claims "
            f"wire_req_bytes={report.wire_req_bytes}")
    want = cfg.n_pull_steps * req_slots * (w_hdr + cfg.pull_row_cap
                                           * w_row) * 4
    if want != report.wire_reply_bytes:
        bad("wire-bytes-reply", "pull",
            f"n_pull_steps({cfg.n_pull_steps}) × slots({req_slots}) × "
            f"(w_hdr({w_hdr}) + pull_row_cap({cfg.pull_row_cap}) × "
            f"w_row({w_row})) × 4 = {want} B but the report claims "
            f"wire_reply_bytes={report.wire_reply_bytes}")

    # --- hub lane (on-shard, no wire — but still capacity-planned) ---
    if cfg.hub_theta != report.hub_theta:
        bad("hub-theta-mismatch", "hub",
            f"config stamps hub_theta={cfg.hub_theta} but the report was "
            f"accounted at θ={report.hub_theta}")
    if report.n_hubs > 0 and cfg.hub_theta < 1:
        bad("hub-theta-mismatch", "hub",
            f"report claims {report.n_hubs} delegated hubs but the config "
            "disables delegation (hub_theta=0)")
    if report.hub_resolved_wedges > 0 and cfg.n_hub_steps < 1:
        bad("plan-truncation-hub", "hub",
            f"the planner routed {report.hub_resolved_wedges} wedges "
            "through the hub table but the plan runs zero hub supersteps")
    elif cfg.n_hub_steps:
        _coverage("plan-truncation-hub", "hub", cfg.n_hub_steps,
                  cfg.hub_wedge_cap, report.hub_stream_max,
                  "hub wedges per heaviest shard", v)

    v += _check_cap_policy(cfg, report, w_push, w_row, w_hdr, w_req)
    return v


def _check_cap_policy(cfg: "EngineConfig", report: "VolumeReport",
                      w_push: int, w_row: int, w_hdr: int,
                      w_req: int) -> list[Violation]:
    """The ``cap_policy`` pass: prove a ``"bucket"`` plan is *the same
    plan, rounded up* — and an ``"exact"`` plan carries a zero-padding
    shadow lane identical to its primary fields.

    Three families of facts, all host arithmetic on the stamped report:

    * **padding tax is the wire difference** (any policy):
      ``bucket_pad_bytes == Σ wire_*_bytes − Σ exact_wire_*_bytes``.
    * **exact shadow lane is itself a valid plan** (any policy): its
      req/reply lanes reconcile word-for-word (reply bytes == steps ×
      slots × (w_hdr + exact_pull_row_cap·w_row) × 4 with the slot count
      recovered from the req lane), and its superstep × capacity products
      still cover the planner's measured stream maxima and entry totals —
      "coverage of fed slots unchanged": bucketing may round capacities
      *up* but can never have hidden a truncation the exact plan would
      have had.
    * **on-grid** (``"bucket"`` only): every shape-determining knob —
      scalar caps, superstep counts, and each per-(src, dest) ragged cap —
      is a fixed point of :func:`repro_torch.utils.bucket_cap`, and
      ``pull_row_cap`` dominates its exact shadow. Under ``"exact"`` the
      shadow fields must instead *equal* the primaries, with zero pad.
    """
    v: list[Violation] = []

    def bad(code: str, where: str, msg: str) -> None:
        v.append(Violation("conservation", code, where, msg))

    if cfg.cap_policy != report.cap_policy:
        bad("cap-policy-mismatch", "plan",
            f"config stamps cap_policy={cfg.cap_policy!r} but the report "
            f"was accounted under {report.cap_policy!r}")
        return v
    if cfg.cap_policy not in ("exact", "bucket"):
        bad("cap-policy-unknown", "plan",
            f"unknown cap_policy {cfg.cap_policy!r} — the planner only "
            "stamps 'exact' or 'bucket'")
        return v

    # padding tax == wire difference, byte for byte
    wire = (report.wire_push_bytes + report.wire_req_bytes
            + report.wire_reply_bytes)
    exact_wire = (report.exact_wire_push_bytes + report.exact_wire_req_bytes
                  + report.exact_wire_reply_bytes)
    if report.bucket_pad_bytes != wire - exact_wire:
        bad("bucket-pad-arithmetic", "plan",
            f"bucket_pad_bytes={report.bucket_pad_bytes} but the wire lanes "
            f"exceed their exact shadows by {wire - exact_wire} B — the "
            "stamped padding tax is not the lane difference")

    # exact shadow lane: reconcile word-for-word, then prove coverage
    ex_steps = report.exact_n_pull_steps
    if ex_steps:
        den = ex_steps * w_req * 4
        ex_req_slots, rem = divmod(report.exact_wire_req_bytes, den)
        if rem:
            bad("bucket-exact-lane", "pull",
                f"exact_wire_req_bytes={report.exact_wire_req_bytes} is not "
                f"a whole number of request slots (exact_n_pull_steps("
                f"{ex_steps}) × w_req({w_req}) × 4 = {den} B/slot)")
        else:
            want = ex_steps * ex_req_slots * (
                w_hdr + report.exact_pull_row_cap * w_row) * 4
            if want != report.exact_wire_reply_bytes:
                bad("bucket-exact-lane", "pull",
                    f"exact reply lane does not reconcile: "
                    f"exact_n_pull_steps({ex_steps}) × slots({ex_req_slots})"
                    f" × (w_hdr({w_hdr}) + exact_pull_row_cap("
                    f"{report.exact_pull_row_cap}) × w_row({w_row})) × 4 = "
                    f"{want} B but the report claims "
                    f"exact_wire_reply_bytes={report.exact_wire_reply_bytes}")
        if report.exact_pull_q_cap > 0:
            _coverage("bucket-exact-truncation", "pull", ex_steps,
                      report.exact_pull_q_cap, report.pull_groups_max,
                      "pulled groups per heaviest pair (exact shadow lane)",
                      v)
    ep_steps = report.exact_n_push_steps
    if ep_steps:
        den = ep_steps * w_push * 4
        ex_push_slots, rem = divmod(report.exact_wire_push_bytes, den)
        if rem:
            bad("bucket-exact-lane", "push",
                f"exact_wire_push_bytes={report.exact_wire_push_bytes} is "
                f"not a whole number of push slots (exact_n_push_steps("
                f"{ep_steps}) × w_push({w_push}) × 4 = {den} B/slot)")
        else:
            entries_need = (report.pushpull_push_entries
                            if cfg.mode == "pushpull"
                            else report.push_only_entries)
            _coverage("bucket-exact-truncation", "push:total", ep_steps,
                      ex_push_slots, entries_need,
                      "wire slots (exact shadow lane)", v)

    if cfg.cap_policy == "exact":
        pairs = (("n_push_steps", cfg.n_push_steps, ep_steps),
                 ("n_pull_steps", cfg.n_pull_steps, ex_steps),
                 ("pull_q_cap", cfg.pull_q_cap, report.exact_pull_q_cap),
                 ("pull_row_cap", cfg.pull_row_cap,
                  report.exact_pull_row_cap),
                 ("wire_push_bytes", report.wire_push_bytes,
                  report.exact_wire_push_bytes),
                 ("wire_req_bytes", report.wire_req_bytes,
                  report.exact_wire_req_bytes),
                 ("wire_reply_bytes", report.wire_reply_bytes,
                  report.exact_wire_reply_bytes))
        for name, primary, shadow in pairs:
            if primary != shadow:
                bad("exact-shadow-mismatch", f"plan:{name}",
                    f"cap_policy='exact' but {name}={primary} differs from "
                    f"its exact shadow {shadow} — under the exact policy "
                    "the shadow lane must equal the plan itself")
        if report.bucket_pad_bytes != 0:
            bad("exact-shadow-mismatch", "plan:bucket_pad_bytes",
                f"cap_policy='exact' but bucket_pad_bytes="
                f"{report.bucket_pad_bytes} — an exact plan carries zero "
                "bucket padding by definition")
        return v

    # --- cap_policy == "bucket": every shape knob on the grid ---
    scalars = (("push_cap", cfg.push_cap),
               ("n_push_steps", cfg.n_push_steps),
               ("pull_q_cap", cfg.pull_q_cap),
               ("pull_edge_cap", cfg.pull_edge_cap),
               ("pull_row_cap", cfg.pull_row_cap),
               ("n_pull_steps", cfg.n_pull_steps),
               ("hub_wedge_cap", cfg.hub_wedge_cap),
               ("n_hub_steps", cfg.n_hub_steps))
    for name, val in scalars:
        if bucket_cap(int(val)) != int(val):
            bad("bucket-off-grid", f"plan:{name}",
                f"cap_policy='bucket' but {name}={int(val)} is not on the "
                f"bucket grid (bucket_cap({int(val)}) = "
                f"{bucket_cap(int(val))}) — an off-grid knob defeats "
                "shape-signature sharing across epochs")
    for name, table in (("push_caps", cfg.push_caps),
                        ("pull_caps", cfg.pull_caps)):
        if table is None:
            continue
        for s, row in enumerate(table):
            for d, x in enumerate(row):
                if bucket_cap(int(x)) != int(x):
                    bad("bucket-off-grid", f"plan:{name}[{s}][{d}]",
                        f"per-pair cap {int(x)} is not on the bucket grid "
                        f"(bucket_cap = {bucket_cap(int(x))})")
                    break
            else:
                continue
            break
    if cfg.pull_row_cap < report.exact_pull_row_cap:
        bad("bucket-below-exact", "plan:pull_row_cap",
            f"bucketed pull_row_cap={cfg.pull_row_cap} is below its exact "
            f"shadow {report.exact_pull_row_cap} — bucketing only ever "
            "rounds capacities up, so reply rows would be truncated")
    return v
