"""Survey callbacks as monoid aggregators (paper Sec. 4.5, Algs 2–4).

A :class:`Survey` folds masked batches of discovered triangles: ``init``
builds one shard's state on a device, ``update`` folds a
:class:`TriangleBatch`, ``merge`` combines the shards' states stacked on
axis 0, ``finalize`` renders results host-side.

Lane-projection contract (as in the JAX package): each survey declares a
:class:`MetaSpec` naming the metadata lanes it reads from the six items of
Δ_pqr. The engine gathers and exchanges only those lanes; unread items
reach ``update`` zero-width (``[B, 0]``), partially read items are
``[B, max(lane) + 1]`` with undeclared lanes zero-filled.

Ported surveys: :class:`TriangleCount` and :class:`DegreeTriples`. The
other built-ins and ``SurveyBundle`` are still to be ported (ROADMAP.md,
Queue 1 item 3). uint32 state lanes (the counter64 limbs, the packed
counting table) are int32 tensors holding the same bits; their names are
in :data:`U32_LEAVES`.
"""
from __future__ import annotations

from dataclasses import dataclass, fields

import numpy as np
import torch

from repro_torch.core.counting_set import CountingSet
from repro_torch.utils import MASK32, u32_bits

_V_ITEMS = ("vp", "vq", "vr")
_E_ITEMS = ("e_pq", "e_pr", "e_qr")

# state leaves whose int32 storage holds uint32 bits
U32_LEAVES = ("lo", "hi", "packed")


@dataclass(frozen=True)
class MetaSpec:
    """Which metadata lanes a survey reads from each of the six items.

    Each field is a tuple of lane indices into the storage columns, or
    ``None`` meaning all lanes (resolved against the graph's widths). The
    default is nothing.
    """

    vp_i: tuple | None = ()
    vp_f: tuple | None = ()
    vq_i: tuple | None = ()
    vq_f: tuple | None = ()
    vr_i: tuple | None = ()
    vr_f: tuple | None = ()
    e_pq_i: tuple | None = ()
    e_pq_f: tuple | None = ()
    e_pr_i: tuple | None = ()
    e_pr_f: tuple | None = ()
    e_qr_i: tuple | None = ()
    e_qr_f: tuple | None = ()

    @classmethod
    def none(cls) -> "MetaSpec":
        return cls()

    @classmethod
    def full(cls) -> "MetaSpec":
        return cls(**{f.name: None for f in fields(cls)})

    @classmethod
    def vertices(cls, i=(), f=()) -> "MetaSpec":
        """Same int/float lanes on all three vertex items vp, vq, vr."""
        kw = {}
        for it in _V_ITEMS:
            kw[f"{it}_i"] = None if i is None else tuple(i)
            kw[f"{it}_f"] = None if f is None else tuple(f)
        return cls(**kw)

    @classmethod
    def edges(cls, i=(), f=()) -> "MetaSpec":
        """Same int/float lanes on all three edge items e_pq, e_pr, e_qr."""
        kw = {}
        for it in _E_ITEMS:
            kw[f"{it}_i"] = None if i is None else tuple(i)
            kw[f"{it}_f"] = None if f is None else tuple(f)
        return cls(**kw)

    def union(self, other: "MetaSpec") -> "MetaSpec":
        def u(a, b):
            if a is None or b is None:
                return None
            return tuple(sorted(set(a) | set(b)))

        return MetaSpec(**{f.name: u(getattr(self, f.name), getattr(other, f.name))
                           for f in fields(MetaSpec)})

    __or__ = union

    def resolve(self, dvi: int, dvf: int, dei: int, def_: int) -> "MetaSpec":
        """``None`` becomes every lane; explicit lanes are deduplicated,
        sorted and validated against the storage widths."""

        def r(lanes, width, name):
            if lanes is None:
                return tuple(range(width))
            lanes = tuple(sorted(set(int(l) for l in lanes)))
            if lanes and (lanes[0] < 0 or lanes[-1] >= width):
                raise ValueError(
                    f"MetaSpec.{name} declares lanes {lanes} but the graph "
                    f"stores only {width} lane(s) for that column")
            return lanes

        kw = {}
        for f in fields(MetaSpec):
            width = ((dvi if f.name.endswith("_i") else dvf)
                     if f.name.startswith("v")
                     else (dei if f.name.endswith("_i") else def_))
            kw[f.name] = r(getattr(self, f.name), width, f.name)
        return MetaSpec(**kw)

    def lane_counts(self) -> tuple[int, ...]:
        """(n_vp, n_vq, n_vr, n_epq, n_epr, n_eqr) declared lanes (int +
        float) per item, for :func:`repro_torch.core.dodgr.meta_widths`."""
        out = []
        for it in _V_ITEMS + _E_ITEMS:
            li, lf = getattr(self, f"{it}_i"), getattr(self, f"{it}_f")
            if li is None or lf is None:
                raise ValueError("lane_counts() needs a resolved MetaSpec; "
                                 "call .resolve(dvi, dvf, dei, def_) first")
            out.append(len(li) + len(lf))
        return tuple(out)


def eff_width(lanes) -> int:
    """Fold-slot width of a projected item: 0 when unread, else the
    smallest width that keeps every declared lane at its storage index."""
    return 0 if not lanes else max(lanes) + 1


def project_lanes(x: torch.Tensor, lanes) -> torch.Tensor:
    """Gather declared lanes from a full-width column: [..., W] → [..., k]
    (the wire form)."""
    if not lanes:
        return x[..., :0]
    if tuple(lanes) == tuple(range(x.shape[-1])):
        return x
    return x[..., list(lanes)]


def expand_lanes(x: torch.Tensor, lanes) -> torch.Tensor:
    """Scatter wire lanes back to the fold form [..., eff_width], zero
    filling undeclared lanes."""
    w = eff_width(lanes)
    if not lanes:
        return x[..., :0]
    if tuple(lanes) == tuple(range(w)):
        return x
    out = x.new_zeros(tuple(x.shape[:-1]) + (w,))
    out[..., list(lanes)] = x
    return out


def narrow_lanes(x: torch.Tensor, lanes) -> torch.Tensor:
    """Project then re-expand in place — the owner-local (no-wire) form."""
    return expand_lanes(project_lanes(x, lanes), lanes)


@dataclass(frozen=True)
class TriangleBatch:
    """A masked batch of triangles Δ_pqr with their six metadata items,
    lane-projected to the running survey's :class:`MetaSpec`."""

    p: torch.Tensor          # [B] i32 global ids
    q: torch.Tensor
    r: torch.Tensor
    vp_i: torch.Tensor       # [B, ≤dvi] i32   meta(p)
    vq_i: torch.Tensor
    vr_i: torch.Tensor
    vp_f: torch.Tensor       # [B, ≤dvf] f32
    vq_f: torch.Tensor
    vr_f: torch.Tensor
    e_pq_i: torch.Tensor     # [B, ≤dei] i32   meta(p,q)
    e_pr_i: torch.Tensor
    e_qr_i: torch.Tensor
    e_pq_f: torch.Tensor     # [B, ≤def] f32
    e_pr_f: torch.Tensor
    e_qr_f: torch.Tensor
    valid: torch.Tensor      # [B] bool

    def shard(self, s: int) -> "TriangleBatch":
        """Shard ``s`` of a batch whose fields carry a leading shard axis."""
        return TriangleBatch(**{f.name: getattr(self, f.name)[s]
                                for f in fields(self)})


class Survey:
    """Base survey. Subclasses override the hooks and declare
    ``meta_spec``."""

    meta_spec: MetaSpec = MetaSpec.full()

    def init(self, device) -> dict:
        raise NotImplementedError

    def update(self, state: dict, tri: TriangleBatch) -> dict:
        raise NotImplementedError

    def merge(self, stacked: dict) -> dict:
        """Default cross-shard merge: elementwise sum over the shard axis."""
        return {k: v.sum(0, dtype=v.dtype) for k, v in stacked.items()}

    def finalize(self, merged: dict):
        return {k: v.cpu().numpy() for k, v in merged.items()}

    def merge_epochs(self, prev: dict, delta: dict) -> dict:
        return {k: prev[k] + delta[k] for k in prev}

    def scale_sampled(self, result, p: float):
        return result


def _scale_counting_set(result: dict, p: float) -> dict:
    """1/p³ debias for a finalized CountingSet readout (counts go float)."""
    return dict(
        counts={k: v / p**3 for k, v in result["counts"].items()},
        n_collided_slots=result["n_collided_slots"],
        count_in_collided=result["count_in_collided"] / p**3,
    )


# ---------------------------------------------------------------------------
# 64-bit counter from uint32 limbs (int32 tensors holding the bits); the
# limb arithmetic runs in int64 masked to 32 bits


def _u64(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int64) & MASK32


def counter64_zero(device) -> dict:
    z = torch.zeros((), dtype=torch.int32, device=device)
    return dict(lo=z, hi=z.clone())


def counter64_add(c: dict, amount: torch.Tensor) -> dict:
    """Add a non-negative amount below 2³² (an int64 tensor)."""
    lo = _u64(c["lo"]) + amount
    hi = _u64(c["hi"]) + (lo >> 32)
    return dict(lo=u32_bits(lo & MASK32), hi=u32_bits(hi & MASK32))


def counter64_value(c: dict) -> int:
    lo = int(c["lo"].cpu().numpy().view(np.uint32))
    hi = int(c["hi"].cpu().numpy().view(np.uint32))
    return hi * 2**32 + lo


class TriangleCount(Survey):
    """Alg. 2 — global triangle count (metadata ignored)."""

    meta_spec = MetaSpec.none()

    def init(self, device) -> dict:
        return counter64_zero(device)

    def update(self, state, tri):
        return counter64_add(state, tri.valid.sum())

    def merge(self, stacked):
        # exact in int64 for any S < 2³¹: lo carries every 2³² wrap into hi
        s_lo = _u64(stacked["lo"]).sum()
        s_hi = _u64(stacked["hi"]).sum() + (s_lo >> 32)
        return dict(lo=u32_bits(s_lo & MASK32), hi=u32_bits(s_hi & MASK32))

    def finalize(self, merged):
        return counter64_value(merged)

    def merge_epochs(self, prev, delta):
        lo = _u64(prev["lo"]) + _u64(delta["lo"])
        hi = _u64(prev["hi"]) + _u64(delta["hi"]) + (lo >> 32)
        return dict(lo=u32_bits(lo & MASK32), hi=u32_bits(hi & MASK32))

    def scale_sampled(self, result, p: float):
        return result / p**3


_LN2_F32 = float(np.float32(np.log(2.0)))


def ceil_log2_f32(d: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``ceil(log(f) / log(2))`` in float32 of
    f = float32(max(d, 1)), on any device: log(f) is taken in float64 and
    rounded once to float32 (a correctly rounded float32 log), then divided
    by float32 ln 2 in float32 (a tensor divisor: a scalar one may become a
    multiplication by its reciprocal). Like the reference it is not the
    exact ⌈log₂ d⌉: it rounds down just above a power of two from 2²¹ on
    (2²¹ + 1 gives 21)."""
    f = d.clamp_min(1).to(torch.float32)
    ln = torch.log(f.to(torch.float64)).to(torch.float32)
    ln2 = torch.tensor(_LN2_F32, dtype=torch.float32, device=d.device)
    return torch.ceil(ln / ln2).to(torch.int32)


class DegreeTriples(Survey):
    """Sec. 5.9 — count (⌈log₂ d(p)⌉, ⌈log₂ d(q)⌉, ⌈log₂ d(r)⌉) triples.

    Degrees are a vertex int metadata column (``with_degree_meta``). Uses
    the counting set. ``update`` folds only the valid lanes: masked lanes
    would add the identities of add and unsigned max, so the tables equal
    the reference's full-batch fold bit for bit.

    ``_lg`` reproduces the JAX package's float32 ``ceil(log2)``, rounding
    included, so the bins equal the reference's for every int32 degree
    (``ceil_log2_f32``).
    """

    def __init__(self, deg_col: int = 0, capacity: int = 4096,
                 counting_backend: str = "auto"):
        self.deg_col = deg_col
        self.cs = CountingSet(capacity, 3, backend=counting_backend)
        self.meta_spec = MetaSpec.vertices(i=(deg_col,))

    def _lg(self, d):
        return ceil_log2_f32(d)

    def init(self, device):
        return self.cs.init(device)

    def scale_sampled(self, result, p: float):
        return _scale_counting_set(result, p)

    def update(self, state, tri):
        idx = tri.valid.nonzero().squeeze(1)
        c = self.deg_col
        keys = self._lg(torch.stack([tri.vp_i[idx, c], tri.vq_i[idx, c],
                                     tri.vr_i[idx, c]], -1))
        valid = torch.ones(keys.shape[0], dtype=torch.bool, device=keys.device)
        return self.cs.increment(state, keys, valid)

    def merge(self, stacked):
        return self.cs.merge(stacked)

    def merge_epochs(self, prev, delta):
        return self.cs.merge_epochs(prev, delta)

    def finalize(self, merged):
        return self.cs.finalize(merged)
