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

Every built-in survey of the JAX package is here, and
:class:`SurveyBundle` folds several in one traversal. A state is a tensor,
a dict of tensors, or (for a bundle) a tuple of states; the engine stacks
and merges any of them. uint32 state lanes (the counter64 limbs, the
packed counting table) are int32 tensors holding the same bits; their
names are in :data:`U32_LEAVES`.

Scatter folds go through the port's kernels: the dense histograms
(:class:`LocalVertexCount`, :class:`ClosureTime`,
:class:`MaxEdgeLabelDist`) through ``hist_add``, the counting set through
``fold_count_max`` (or ``hist_add`` + ``hist_max``), :class:`Enumerate`'s
ring buffer through ``ring_set``. Each is the CUDA kernel for tensors on
the card and its plain PyTorch version on the CPU.
"""
from __future__ import annotations

from dataclasses import dataclass, fields
from functools import cached_property

import numpy as np
import torch

from repro_torch.core.counting_set import CountingSet
from repro_torch.kernels.fold_scatter import ops as fs_ops
from repro_torch.kernels.hist import ops as hist_ops
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

    @classmethod
    def zeros(cls, spec: MetaSpec, batch: int = 64,
              device=None) -> "TriangleBatch":
        """A batch of ``batch`` lanes at ``spec``'s projected widths, every
        field zero and every lane valid: what the fold-determinism trace
        (:mod:`repro_torch.analysis.contracts`) runs a survey's ``update``
        on, as the JAX package traces its ``TriangleBatch.abstract``.
        ``spec`` must be resolved (:meth:`MetaSpec.resolve`)."""
        def item(lanes, dtype):
            if lanes is None:
                raise ValueError("TriangleBatch.zeros() needs a resolved "
                                 "MetaSpec; call .resolve(dvi, dvf, dei, "
                                 "def_) first")
            return torch.zeros((batch, eff_width(lanes)), dtype=dtype,
                               device=device)

        ids = {k: torch.zeros(batch, dtype=torch.int32, device=device)
               for k in "pqr"}
        meta = {f"{it}_{kind}": item(getattr(spec, f"{it}_{kind}"), dtype)
                for it in _V_ITEMS + _E_ITEMS
                for kind, dtype in (("i", torch.int32), ("f", torch.float32))}
        return cls(**ids, **meta,
                   valid=torch.ones(batch, dtype=torch.bool, device=device))

    def shard(self, s: int) -> "TriangleBatch":
        """Shard ``s`` of a batch whose fields carry a leading shard axis."""
        return TriangleBatch(**{f.name: getattr(self, f.name)[s]
                                for f in fields(self)})

    @cached_property
    def valid_index(self) -> torch.Tensor:
        """Indices of the valid lanes, found once per batch (one host sync)
        and shared by every fold that reads only valid lanes: a fold whose
        masked lanes would add only identities folds these alone, the same
        table from a fraction of a padded pull window. On the meta device
        (a dry-run trace) every lane counts as valid: the reference's
        static fold width, so a prediction built on it is an upper
        bound."""
        if self.valid.device.type == "meta":
            return torch.arange(self.valid.shape[0], device=self.valid.device)
        return self.valid.nonzero().squeeze(1)


def tree_map(fn, *trees):
    """Apply ``fn`` leafwise over states of one structure: a tensor, a dict
    of states or a tuple/list of states (the reference's pytree map)."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(tree_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


class Survey:
    """Base survey. Subclasses override the hooks and declare
    ``meta_spec``."""

    meta_spec: MetaSpec = MetaSpec.full()

    def init(self, device):
        raise NotImplementedError

    def update(self, state, tri: TriangleBatch):
        raise NotImplementedError

    def merge(self, stacked):
        """Default cross-shard merge: elementwise sum over the shard axis."""
        return tree_map(lambda v: v.sum(0, dtype=v.dtype), stacked)

    def finalize(self, merged):
        return tree_map(lambda v: v.cpu().numpy(), merged)

    def merge_epochs(self, prev, delta):
        return tree_map(lambda a, b: a + b, prev, delta)

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


def _ceil_log2_float(d: torch.Tensor) -> torch.Tensor:
    """``ceil(log(f) / log(2))`` as float32, f = float32(max(d, 1)); see
    :func:`ceil_log2_f32`."""
    f = d.clamp_min(1).to(torch.float32)
    ln = torch.log(f.to(torch.float64)).to(torch.float32)
    ln2 = torch.tensor(_LN2_F32, dtype=torch.float32, device=d.device)
    return torch.ceil(ln / ln2)


def ceil_log2_f32(d: torch.Tensor) -> torch.Tensor:
    """The JAX package's ``ceil(log(f) / log(2))`` in float32 of
    f = float32(max(d, 1)), on any device: log(f) is taken in float64 and
    rounded once to float32 (a correctly rounded float32 log), then divided
    by float32 ln 2 in float32 (a tensor divisor: a scalar one may become a
    multiplication by its reciprocal). Like the reference it is not the
    exact ⌈log₂ d⌉: it rounds down just above a power of two from 2²¹ on
    (2²¹ + 1 gives 21)."""
    return _ceil_log2_float(d).to(torch.int32)


def _sort3(a, b, c):
    """Exact 3-way sort by a min/max network (no arithmetic, so bitwise
    equal to the reference's on ints and floats alike)."""
    lo = torch.minimum(torch.minimum(a, b), c)
    hi = torch.maximum(torch.maximum(a, b), c)
    mid = torch.maximum(torch.minimum(a, b), torch.minimum(torch.maximum(a, b), c))
    return lo, mid, hi


def _hist_fold(state: torch.Tensor, slots: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """``state`` (any shape, int32) plus one count at each valid flat slot
    (``hist_add``); invalid lanes go to slot -1, which the fold drops, so
    their slot values are never trusted."""
    s = torch.where(valid, slots.to(torch.int32), -1)
    d = hist_ops.hist_add(s, valid.to(torch.int32), state.numel())
    return state + d.view(state.shape)


class DegreeTriples(Survey):
    """Sec. 5.9 — count (⌈log₂ d(p)⌉, ⌈log₂ d(q)⌉, ⌈log₂ d(r)⌉) triples.

    Degrees are a vertex int metadata column (``with_degree_meta``). Uses
    the counting set. ``update`` folds only the valid lanes
    (:attr:`TriangleBatch.valid_index`): masked lanes would add the
    identities of add and unsigned max, so the tables equal the
    reference's full-batch fold bit for bit.

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
        idx = tri.valid_index
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


class LocalVertexCount(Survey):
    """Per-vertex triangle participation: state [n] int32.

    The reference adds 0 on invalid lanes at whatever ids they carry; the
    port folds only the valid lanes, so garbage ids on masked lanes never
    reach the scatter."""

    meta_spec = MetaSpec.none()

    def __init__(self, n: int):
        self.n = n

    def init(self, device):
        return torch.zeros((self.n,), dtype=torch.int32, device=device)

    def update(self, state, tri):
        idx = tri.valid_index
        ids = torch.cat([tri.p[idx], tri.q[idx], tri.r[idx]])
        return _hist_fold(state, ids, torch.ones_like(ids, dtype=torch.bool))

    def scale_sampled(self, result, p: float):
        return np.asarray(result) / p**3


class ClosureTime(Survey):
    """Alg. 4 — joint (⌈log₂ Δt_open⌉, ⌈log₂ Δt_close⌉) histogram, state
    [n_buckets, n_buckets] int32, from the edge float column ``ts_col``.

    ``_bucket`` follows the reference's float32 ``ceil(log2(max(dt, 1)))``
    rounding (:func:`ceil_log2_f32`) and clamps in float before the int
    conversion, so NaN or garbage can never index out of range. Only the
    valid lanes are folded."""

    def __init__(self, ts_col: int = 0, n_buckets: int = 64):
        self.ts_col = ts_col
        self.nb = n_buckets
        self.meta_spec = MetaSpec.edges(f=(ts_col,))

    def _bucket(self, dt):
        b = torch.nan_to_num(_ceil_log2_float(dt), nan=0.0)
        return b.clamp(0, self.nb - 1).to(torch.int32)

    def init(self, device):
        return torch.zeros((self.nb, self.nb), dtype=torch.int32, device=device)

    def update(self, state, tri):
        idx = tri.valid_index
        c = self.ts_col
        t1, t2, t3 = _sort3(tri.e_pq_f[idx, c], tri.e_pr_f[idx, c],
                            tri.e_qr_f[idx, c])
        slot = self._bucket(t2 - t1) * self.nb + self._bucket(t3 - t1)
        return _hist_fold(state, slot, torch.ones_like(slot, dtype=torch.bool))

    def finalize(self, merged):
        joint = merged.cpu().numpy()
        return dict(joint=joint, close_marginal=joint.sum(0),
                    open_marginal=joint.sum(1))

    def scale_sampled(self, result, p: float):
        return {k: v / p**3 for k, v in result.items()}


class MaxEdgeLabelDist(Survey):
    """Alg. 3 — distribution of the max edge label over triangles whose
    three vertex labels are distinct, state [n_labels] int32. Only the
    valid lanes are folded."""

    def __init__(self, n_labels: int, e_label_col: int = 0, v_label_col: int = 0):
        self.n_labels = n_labels
        self.ec = e_label_col
        self.vc = v_label_col
        self.meta_spec = (MetaSpec.vertices(i=(v_label_col,))
                          | MetaSpec.edges(i=(e_label_col,)))

    def init(self, device):
        return torch.zeros((self.n_labels,), dtype=torch.int32, device=device)

    def update(self, state, tri):
        idx, vc, ec = tri.valid_index, self.vc, self.ec
        lp, lq, lr = tri.vp_i[idx, vc], tri.vq_i[idx, vc], tri.vr_i[idx, vc]
        distinct = (lp != lq) & (lq != lr) & (lp != lr)
        mx = torch.maximum(torch.maximum(tri.e_pq_i[idx, ec], tri.e_pr_i[idx, ec]),
                           tri.e_qr_i[idx, ec]).clamp(0, self.n_labels - 1)
        return _hist_fold(state, mx, distinct)

    def scale_sampled(self, result, p: float):
        return np.asarray(result) / p**3


class LabelTripleSet(Survey):
    """Sec. 5.8 — count sorted vertex-label triples (distinct labels only,
    by default) in the counting set. Folds only the valid lanes, as
    :class:`DegreeTriples` does."""

    def __init__(self, v_label_col: int = 0, capacity: int = 1 << 16,
                 require_distinct: bool = True,
                 counting_backend: str = "auto"):
        self.vc = v_label_col
        self.require_distinct = require_distinct
        self.cs = CountingSet(capacity, 3, backend=counting_backend)
        self.meta_spec = MetaSpec.vertices(i=(v_label_col,))

    def init(self, device):
        return self.cs.init(device)

    def update(self, state, tri):
        idx, c = tri.valid_index, self.vc
        l1, l2, l3 = _sort3(tri.vp_i[idx, c], tri.vq_i[idx, c], tri.vr_i[idx, c])
        if self.require_distinct:
            valid = (l1 != l2) & (l2 != l3)
        else:
            valid = torch.ones_like(l1, dtype=torch.bool)
        return self.cs.increment(state, torch.stack([l1, l2, l3], -1), valid)

    def scale_sampled(self, result, p: float):
        return _scale_counting_set(result, p)

    def merge(self, stacked):
        return self.cs.merge(stacked)

    def merge_epochs(self, prev, delta):
        return self.cs.merge_epochs(prev, delta)

    def finalize(self, merged):
        return self.cs.finalize(merged)


class Enumerate(Survey):
    """Triangle enumeration into a fixed-capacity per-shard ring buffer.

    ``triangles`` in the finalized result is a capacity-bounded sample:
    once a shard finds more than ``capacity`` triangles the ring wraps and
    earlier entries are overwritten. ``total_found`` stays exact and
    ``overflowed`` counts the triangles missing from the buffer.

    Every write goes through ``ring_set``, whose wrap winner is the
    highest batch index: the JAX package's ``backend="pallas"`` result,
    which its ``"scatter"`` backend equals whenever the buffer does not
    wrap. ``backend`` and ``pallas_interpret`` are kept so configurations
    compare field by field with the JAX package; the device alone picks
    the CUDA kernel or its plain version."""

    meta_spec = MetaSpec.none()

    def __init__(self, capacity: int, backend: str = "auto",
                 pallas_interpret: bool | None = None):
        if backend not in ("auto", "pallas", "scatter"):
            raise ValueError(f"unknown Enumerate backend {backend!r}")
        self.capacity = capacity
        self.backend = backend
        self.pallas_interpret = pallas_interpret

    def init(self, device):
        return dict(
            tris=torch.full((self.capacity, 3), -1, dtype=torch.int32, device=device),
            n=torch.zeros((), dtype=torch.int32, device=device),
        )

    def update(self, state, tri):
        cap = self.capacity
        amt = tri.valid.to(torch.int32)
        offs = torch.cumsum(amt, 0, dtype=torch.int32) - amt + state["n"]
        # invalid lanes go to slot ``capacity``, which ring_set drops; it
        # reads no row of a dropped lane, so the rows need no zeroing (the
        # reference zeroes them for its one-hot sum), and it reads the
        # winners' rows from the columns where they lie, unstacked
        idx = torch.where(tri.valid, offs % cap, cap)
        tris = fs_ops.ring_set(state["tris"], idx, (tri.p, tri.q, tri.r), cap)
        return dict(tris=tris, n=state["n"] + amt.sum(dtype=torch.int32))

    def merge(self, stacked):
        # concatenation semantics: the per-shard buffers stay stacked
        return stacked

    def merge_epochs(self, prev, delta):
        return tree_map(lambda a, b: torch.cat([a, b], 0), prev, delta)

    def finalize(self, merged):
        tris = merged["tris"].cpu().numpy().reshape(-1, 3)
        tris = tris[tris[:, 0] >= 0]
        n = merged["n"].cpu().numpy().astype(np.int64)
        return dict(
            triangles=tris,
            total_found=int(n.sum()),
            overflowed=int(np.maximum(n - self.capacity, 0).sum()),
        )


class SurveyBundle(Survey):
    """N surveys folded in one traversal (the "poll" in TriPoll): one
    :class:`TriangleBatch` fans out to every member, whose states live in
    one tuple. The bundle's ``meta_spec`` is the union of its members', so
    the engine ships exactly the lanes some member reads. A bundle of one
    is unwrapped: the member's state flows bare, and only ``finalize``
    wraps the result under the member's name."""

    def __init__(self, surveys, names=None):
        self.surveys = tuple(surveys)
        if not self.surveys:
            raise ValueError("SurveyBundle needs at least one member survey")
        if names is None:
            names, seen = [], {}
            for s in self.surveys:
                base = type(s).__name__
                k = seen.get(base, 0)
                seen[base] = k + 1
                names.append(base if k == 0 else f"{base}_{k}")
        if len(names) != len(self.surveys):
            raise ValueError("names/surveys length mismatch")
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate survey names: {names}")
        self.names = tuple(names)
        self._solo = self.surveys[0] if len(self.surveys) == 1 else None
        spec = MetaSpec.none()
        for s in self.surveys:
            spec = spec | getattr(s, "meta_spec", MetaSpec.full())
        self.meta_spec = spec

    def init(self, device):
        if self._solo is not None:
            return self._solo.init(device)
        return tuple(s.init(device) for s in self.surveys)

    def update(self, state, tri):
        if self._solo is not None:
            return self._solo.update(state, tri)
        return tuple(s.update(st, tri) for s, st in zip(self.surveys, state))

    def merge(self, stacked):
        if self._solo is not None:
            return self._solo.merge(stacked)
        return tuple(s.merge(st) for s, st in zip(self.surveys, stacked))

    def merge_epochs(self, prev, delta):
        if self._solo is not None:
            return self._solo.merge_epochs(prev, delta)
        return tuple(s.merge_epochs(p, d)
                     for s, p, d in zip(self.surveys, prev, delta))

    def finalize(self, merged):
        if self._solo is not None:
            return {self.names[0]: self._solo.finalize(merged)}
        return {n: s.finalize(m)
                for n, s, m in zip(self.names, self.surveys, merged)}

    def scale_sampled(self, result, p: float):
        return {n: s.scale_sampled(result[n], p)
                for n, s in zip(self.names, self.surveys)}


class TopKWeightedTriangles(Survey):
    """Top-k heaviest triangles, weight = the float32 sum
    ``(e_pq + e_pr) + e_qr`` of an edge float column (after Kumar et al.).

    Each selection orders the whole concatenation of the k-slot state and
    the batch by (weight desc, p, q, r) — the reference's
    ``lexsort((r, q, p, -w))`` as four chained stable sorts — and keeps
    the first k, so the state, its ``-inf`` tail rows included, is the
    reference's bit for bit, and ties resolve the same way on any shard
    count or transport."""

    def __init__(self, k: int, weight_col: int = 0):
        self.k = k
        self.wc = weight_col
        self.meta_spec = MetaSpec.edges(f=(weight_col,))

    def init(self, device):
        return dict(
            w=torch.full((self.k,), -np.inf, dtype=torch.float32, device=device),
            tri=torch.full((self.k, 3), -1, dtype=torch.int32, device=device),
        )

    def _select(self, w, p, q, r):
        """The first k of (w, p, q, r) columns under (-w, p, q, r, position)
        order."""
        order = torch.sort(r, stable=True).indices
        for key in (q, p, -w):
            order = order[torch.sort(key[order], stable=True).indices]
        idx = order[: self.k]
        return dict(w=w[idx], tri=torch.stack([p[idx], q[idx], r[idx]], -1))

    def _select_rows(self, w, tri):
        return self._select(w, tri[:, 0], tri[:, 1], tri[:, 2])

    def update(self, state, tri):
        c = self.wc
        w = (tri.e_pq_f[:, c] + tri.e_pr_f[:, c]) + tri.e_qr_f[:, c]
        w = torch.where(tri.valid, w, -np.inf)
        st = state["tri"]
        return self._select(torch.cat([state["w"], w]),
                            *(torch.cat([st[:, i], x])
                              for i, x in enumerate((tri.p, tri.q, tri.r))))

    def merge(self, stacked):
        S = stacked["w"].shape[0]
        return self._select_rows(stacked["w"].reshape(S * self.k),
                                 stacked["tri"].reshape(S * self.k, 3))

    def merge_epochs(self, prev, delta):
        return self._select_rows(torch.cat([prev["w"], delta["w"]]),
                                 torch.cat([prev["tri"], delta["tri"]]))

    def finalize(self, merged):
        w = merged["w"].cpu().numpy()
        tri = merged["tri"].cpu().numpy()
        keep = np.isfinite(w)
        return dict(weights=w[keep], triangles=tri[keep])
