"""The card's published rates, the roofline terms of one traced call
(:func:`analyze_counted`), and the mesh transport's collective bytes:
planned (:func:`mesh_collective_plan`) and reconciled with what the ranks
counted (:func:`reconcile_collectives`).

The JAX package reads FLOPs, bytes and memory from a compiled program
(``cost_analysis``, ``memory_analysis``) and its collective bytes from
the compiled HLO text (``repro.roofline.collective_bytes``). The port has
no compiled program: :func:`analyze_counted` takes the counts of every op
a call executes (:class:`repro_torch.roofline.count.OpCounter`), and the
mesh's collective bytes are its own counters: every operand handed to
``torch.distributed`` is counted, per lane, where it is handed over
(``launch.mesh.ShardMesh.count``), and ``RankRun`` returns each rank's
counters. So no HLO parser is ported.
"""
from __future__ import annotations

from dataclasses import dataclass

# the exchange lanes of the engine's mesh transport, as ShardMesh counts
# them (the push lane's gather, "push_back", never runs), and the lane of
# the state and stats all-gather, which is reported and not reconciled
WIRE_LANES = ("push", "req", "reply")
MERGE_LANE = "merge"


@dataclass(frozen=True)
class HW:
    """NVIDIA H100 SXM 80GB, from its data sheet."""

    peak_flops: float = 989e12       # dense bf16 tensor-core FLOP/s
    hbm_bw: float = 3.35e12          # device memory B/s
    link_bw: float = 450e9           # NVLink B/s each way
    hbm_bytes: float = 80e9          # device memory capacity
    # the kernel bounds' operation rate: the data sheet gives no int32
    # rate; its float32 rate outside the tensor cores (67 T/s) is at least
    # the int32 one, so a bound from it stays a lower bound
    peak_int32_ops: float = 67e12


def analyze_counted(counts: dict, model_flops_total: float,
                    hw: HW = HW()) -> dict:
    """Roofline terms of one call on one card, from its op counts
    (``OpCounter.result()``), with the record keys of the JAX package's
    ``analyze_compiled``.

    The FLOPs and bytes are counted per executed op, not read from a
    compiled program: each layer and each superstep counts on every trip,
    so no loop correction applies. ``n_devices`` is 1 and no collective
    runs (``collectives.wire_bytes`` 0); the peak is the counted peak of
    live storage, arguments and outputs included, so ``temp_bytes`` is
    what it holds above them and ``alias_bytes`` is 0; ``fits_hbm`` holds
    when the peak is within the card's memory. The compute term takes
    every FLOP at the bf16 tensor-core rate, as the reference takes its
    chip's bf16 peak.
    """
    flops, nbytes = float(counts["flops"]), float(counts["bytes"])
    peak = int(counts["peak_bytes"])
    mem_info = dict(
        argument_bytes=int(counts["argument_bytes"]),
        output_bytes=int(counts["output_bytes"]),
        temp_bytes=peak - int(counts["argument_bytes"])
        - int(counts["output_bytes"]),
        alias_bytes=0, code_bytes=0)
    coll = dict(per_kind={}, counts={}, ops=[],
                unknown=dict(bytes=0, count=0, mnemonics=[]), wire_bytes=0)
    terms = dict(compute_s=flops / hw.peak_flops,
                 memory_s=nbytes / hw.hbm_bw, collective_s=0.0)
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    return dict(
        n_devices=1,
        flops_per_device=flops,
        bytes_per_device=nbytes,
        collectives=coll,
        memory=mem_info,
        peak_device_bytes=peak,
        fits_hbm=bool(peak <= hw.hbm_bytes),
        terms=terms,
        dominant=dominant,
        bound_time_s=bound,
        model_flops_total=model_flops_total,
        hlo_flops_total=flops,
        useful_flops_ratio=model_flops_total / flops if flops else 0.0,
        roofline_fraction=(model_flops_total / hw.peak_flops / bound
                           if bound > 0 else 0.0),
    )


def mesh_collective_plan(cfg, S: int | None = None) -> dict:
    """Planned collective bytes of one mesh survey run, from an
    ``EngineConfig`` planned for ``transport='mesh'`` (or a dense plan
    relabelled ``mesh``: uniform caps).

    The JAX package's model, with its fields and their meaning: every rank
    holds each round's padded operand (uniform caps: the whole ``[S·cap]``
    all-to-all block, self chunk included; ragged caps: the scheduled
    rounds' padded slots, self diagonal excluded:
    ``MeshExchange.wire_round_slots``). ``lanes`` are its bytes per lane
    over all ranks and supersteps, ``total_bytes`` their sum,
    ``per_device_bytes`` one rank's; ``per_kind`` splits them into
    ``all-to-all`` (uniform caps: one ``all_to_all_single``) and
    ``collective-permute`` (scheduled rounds: one ``batch_isend_irecv``
    each); ``padding_rounds`` has one entry per scheduled round (its pure
    padding bytes over all ranks and supersteps) and one negative
    ``resident`` entry per ragged lane (the self-diagonal words that never
    cross the wire), so that Σ entries == ``total_bytes`` − the
    ``VolumeReport``'s wire bytes; ``schedules`` gives each ragged lane's
    rounds and padding beside the naive rotation's. Per-slot word widths
    are the planner's: ``w_push`` on the push lane, ``w_req`` forward and
    ``w_hdr + pull_row_cap·w_row`` back on the pull lane.

    The port's physical model adds: a rank that is no source of a round
    sends nothing in it, so what the ranks hand to the collectives is each
    source's padded slice (``MeshExchange.sent_round_slots``).
    ``sent_bytes`` gives it per lane, ``sent_total_bytes`` its sum,
    ``per_device_lanes`` one rank's most per lane under the JAX package's
    model (no rank hands over more), and ``sent_padding_rounds`` the
    padding breakdown in these terms (Σ == ``sent_total_bytes`` − the
    ``VolumeReport``'s wire bytes).
    """
    from repro_torch.comm.exchange import make_exchange

    if cfg.meta_widths is None:
        raise ValueError("cfg.meta_widths is None — pass a planned config "
                         "(pushpull.plan_engine stamps the wire widths)")
    w_push, w_row, w_hdr, w_req = cfg.meta_widths
    if S is None:
        if cfg.push_caps is None:
            raise ValueError("S not given and cfg.push_caps is None")
        S = len(cfg.push_caps)
    per_kind: dict = {}
    lanes = dict(push=0, req=0, reply=0)
    sent = dict(push=0, req=0, reply=0)
    per_device_lanes = dict(push=0, req=0, reply=0)
    padding_rounds: list = []
    sent_padding_rounds: list = []
    schedules: dict = {}

    def lane(exch, n_steps, words_per_slot, key):
        word = words_per_slot * 4
        b = n_steps * S * exch.wire_round_slots() * word
        lanes[key] = b
        per_device_lanes[key] = n_steps * exch.wire_round_slots() * word
        sent[key] = n_steps * exch.sent_round_slots() * word
        kind = "all-to-all" if exch.uniform else "collective-permute"
        per_kind[kind] = per_kind.get(kind, 0) + b
        if exch.uniform:
            # the all-to-all ships the exact logical block grid: no padding
            padding_rounds.append(dict(lane=key, round=0, slots=exch.out_cap,
                                       bytes=0))
            sent_padding_rounds.append(dict(lane=key, round=0,
                                            slots=exch.out_cap, bytes=0))
            return
        sc, naive = exch.schedule, exch.naive_schedule
        schedules[key] = dict(
            method=sc.method, rounds=sc.n_rounds, wire_slots=sc.wire_slots,
            naive_rounds=naive.n_rounds, naive_slots=naive.wire_slots,
            padding_bytes=n_steps * sc.padding_slots() * word,
            naive_padding_bytes=n_steps * naive.padding_slots() * word)
        for i, rnd in enumerate(sc.wire_rounds):
            shipped = sum(p.length for p in rnd.parts)
            padding_rounds.append(dict(
                lane=key, round=i, slots=rnd.slots,
                bytes=n_steps * (S * rnd.slots - shipped) * word))
            sent_padding_rounds.append(dict(
                lane=key, round=i, slots=rnd.slots,
                bytes=n_steps * (len(rnd.parts) * rnd.slots - shipped)
                      * word))
        resident = sum(p.length for p in sc.local_parts)
        if resident:
            for rounds in (padding_rounds, sent_padding_rounds):
                rounds.append(dict(lane=key, round=-1, slots=0,
                                   bytes=-n_steps * resident * word))

    push = make_exchange("mesh", S, cfg.push_cap, cfg.push_caps)
    lane(push, cfg.n_push_steps, w_push, "push")
    if cfg.mode == "pushpull" and cfg.n_pull_steps:
        pull = make_exchange("mesh", S, cfg.pull_q_cap, cfg.pull_caps)
        lane(pull, cfg.n_pull_steps, w_req, "req")
        lane(pull, cfg.n_pull_steps, w_hdr + cfg.pull_row_cap * w_row,
             "reply")
    total = sum(lanes.values())
    return dict(per_kind=per_kind, lanes=lanes, total_bytes=total,
                per_device_bytes=total // S, n_devices=S,
                padding_rounds=padding_rounds, schedules=schedules,
                sent_bytes=sent, sent_total_bytes=sum(sent.values()),
                per_device_lanes=per_device_lanes,
                sent_padding_rounds=sent_padding_rounds)


def reconcile_collectives(measured, cfg, S: int | None = None,
                          volume=None) -> dict:
    """Hold the bytes the ranks handed to the collectives against the mesh
    plan, lane by lane.

    ``measured`` is the per-lane byte counters (``ShardMesh.counters
    ["bytes"]``, as ``RankRun`` returns them in each job's ``bytes``):
    summed over the ranks, or a list of each rank's (then each rank is
    also held to the schedule's per-device bytes). ``ok`` holds when

    * the ``push``, ``req`` and ``reply`` lanes each equal the plan's
      ``sent_bytes`` exactly;
    * no rank handed a lane more than ``per_device_lanes`` (where the
      ranks are given);
    * no other lane was counted: ``merge`` (the state and stats
      all-gather) is reported under ``other_bytes`` and not reconciled,
      any other lane lands in ``extra_bytes`` and fails — the model has a
      hole;
    * with ``volume`` (the plan's ``VolumeReport``): a uniform lane's
      bytes equal the report's wire bytes, and each padding breakdown sums
      to its total less the report's (logical) wire bytes:
      ``padding_rounds`` to the JAX package's ``total_bytes`` (the
      identity it asserts for its model), ``sent_padding_rounds`` to the
      port's ``sent_total_bytes``. ``padding_bytes`` is the port's
      (``sent_padding_rounds``), per lane in ``lanes``.
    """
    ranks = None
    if isinstance(measured, (list, tuple)):
        ranks = [dict(r) for r in measured]
        names = sorted({k for r in ranks for k in r})
        measured = {k: sum(r.get(k, 0) for r in ranks) for k in names}
    plan = mesh_collective_plan(cfg, S=S)
    lanes, ok = {}, True
    for key in WIRE_LANES:
        got = int(measured.get(key, 0))
        row = dict(measured=got, sent=plan["sent_bytes"][key],
                   per_device=plan["per_device_lanes"][key])
        row["ok"] = got == row["sent"]
        if ranks is not None:
            row["rank_max"] = max(r.get(key, 0) for r in ranks)
            row["ok"] &= row["rank_max"] <= row["per_device"]
        ok &= row["ok"]
        lanes[key] = row
    other = int(measured.get(MERGE_LANE, 0))
    extra = {k: int(v) for k, v in measured.items()
             if k not in WIRE_LANES and k != MERGE_LANE}
    ok &= not extra
    out = dict(
        measured_bytes=sum(lanes[k]["measured"] for k in WIRE_LANES),
        planned_bytes=plan["sent_total_bytes"],
        other_bytes=other,
        extra_bytes=sum(extra.values()),
        extra_lanes=extra,
        lanes=lanes,
        plan=plan,
        measured=dict(measured),
    )
    if volume is not None:
        wire = dict(push=volume.wire_push_bytes, req=volume.wire_req_bytes,
                    reply=volume.wire_reply_bytes)
        logical = sum(wire.values())
        out["volume_wire_bytes"] = logical
        out["padding_rounds"] = plan["padding_rounds"]
        out["sent_padding_rounds"] = plan["sent_padding_rounds"]
        out["model_padding_bytes"] = sum(
            e["bytes"] for e in plan["padding_rounds"])
        out["padding_bytes"] = sum(
            e["bytes"] for e in plan["sent_padding_rounds"])
        out["padding_ok"] = (
            out["model_padding_bytes"] == plan["total_bytes"] - logical
            and out["padding_bytes"] == plan["sent_total_bytes"] - logical)
        ok &= out["padding_ok"]
        for key, row in lanes.items():
            row["volume"] = wire[key]
            row["padding"] = sum(e["bytes"] for e in plan["sent_padding_rounds"]
                                 if e["lane"] == key)
            if key in plan["schedules"] or not plan["sent_bytes"][key]:
                continue
            row["ok"] &= row["sent"] == wire[key]    # uniform caps
            ok &= row["ok"]
    out["ok"] = bool(ok)
    return out
