"""Per-op counts of one traced call: FLOPs, bytes moved and the peak of
live storage — the port's stand-in for XLA's ``cost_analysis`` and
``memory_analysis`` of a compiled program.

Eager PyTorch has no compiled program to ask, so :class:`OpCounter`, a
``TorchDispatchMode``, watches every aten op the call executes (the
backward's too, when the call runs autograd inside the mode), usually on
the meta device, where nothing is allocated or computed:

* **FLOPs** by ``torch.utils.flop_counter``'s formulas (matrix products,
  convolutions, attention); every other op counts none, as in
  ``FlopCounterMode``.
* **Bytes**: each op reads its tensor inputs once and writes its outputs
  once, with four kinds of exception. Views and other ops whose every
  output aliases an input, and ``empty``-style allocations, move nothing.
  Gathers (``gather``, ``index``, ``index_select``, ``embedding``,
  ``take``) read from their source only as many elements as they write.
  Scatters (``index_put``, ``scatter*``, ``index_add``, ``index_copy``,
  ``index_fill``) read their indices and values and write as many
  destination elements as they are given (read too where they
  accumulate); the out-of-place ones also copy the destination. Searches
  (``searchsorted``, and the port's ``wedge_check``, ``wedge_intersect``
  and ``intersect`` kernels) read the keys they probe, a lower bound's
  steps per query, at most the whole key arrays.
* **Peak**: the largest sum, over the call, of the bytes of every live
  storage on the traced device, each rounded up to 512 bytes (the CUDA
  caching allocator's granule, so the sum is what
  ``torch.cuda.max_memory_allocated`` counts). A storage is counted once,
  however many tensors view it, from the op that first returns it (the
  arguments' and any earlier tensor's from the start or their first use)
  until it is freed: a ``weakref.finalize`` on the storage fires when
  its last tensor dies, saved tensors of autograd included, as those
  hold it. Two ops also hold a workspace of their CUDA kernels while they
  run (:func:`workspace`, measured on an H100 with torch 2.11):
  ``cumsum`` its scan's tile state (and an upcast copy of its input),
  ``sort`` its radix sort's buffers.

``OpCounter(args)`` counts the argument storages as live from the start;
:meth:`OpCounter.result` gives the totals, the argument and output bytes,
and the ops with the most bytes.

Meta kernels are slow (a pointwise op takes ~0.2 ms, ``clamp`` ~1.5 ms,
most of it Python), and a survey repeats the same ops at the same shapes
superstep after superstep. So on the meta device the counter memoizes
each op that returns fresh tensors (no view, nothing written in place):
keyed by the op, its tensors' shapes, strides and dtypes and its other
arguments (scalars with their types), a repeat gets new empty tensors of
the first call's shapes, strides and dtypes without running the kernel.
The counts are the same either way (``memo=False`` runs every kernel).
``cumsum``'s meta kernel builds an [n, n] mask, which overflows past ~3·10⁹
elements, so on meta its output is made from its input's shape.
"""
from __future__ import annotations

import dataclasses
import math
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# allocations that write nothing
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided", "resize_"}
# gathers: the source (first tensor argument) is read where the output is
_GATHERS = {"gather", "index", "index_select", "embedding", "take"}
# scatters: the first argument is the destination; "accumulate" ones
# read what they update
_SCATTERS = {"index_put", "index_put_", "_index_put_impl_", "scatter",
             "scatter_", "index_copy", "index_copy_", "index_fill",
             "index_fill_"}
_ACCUMULATING = {"scatter_add", "scatter_add_", "scatter_reduce",
                 "scatter_reduce_", "index_add", "index_add_"}
# the port's key-search kernels (their fakes on the meta device)
_KERNEL_SEARCHES = {"wedge_check", "wedge_intersect", "intersect"}


# argument types that hold no tensor
_LEAVES = (int, float, bool, str, type(None), torch.dtype, torch.device,
           torch.layout, torch.memory_format)


def _tensors(tree, out=None) -> list:
    """The tensors of nested lists, tuples, dicts and dataclasses, in
    order."""
    out = [] if out is None else out
    for x in (tree if type(tree) in (list, tuple) else (tree,)):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, _LEAVES):
            continue
        elif isinstance(x, (list, tuple)):
            _tensors(x, out)
        elif isinstance(x, dict):
            _tensors(list(x.values()), out)
        elif dataclasses.is_dataclass(x) and not isinstance(x, type):
            _tensors([getattr(x, f.name) for f in dataclasses.fields(x)], out)
    return out


def _memo_key(x):
    """A hashable key of an op argument: a tensor's metadata, a scalar
    with its type (``1``, ``1.0`` and ``True`` differ), containers by
    their items."""
    if isinstance(x, torch.Tensor):
        return (x.shape, x.stride(), x.dtype, x.is_meta)
    if isinstance(x, (list, tuple)):
        return (type(x),) + tuple(_memo_key(v) for v in x)
    if isinstance(x, dict):
        return (dict,) + tuple((k, _memo_key(v)) for k, v in sorted(x.items()))
    return (type(x), x)


def _recipe(out, in_keys: set):
    """How to remake ``out`` (a tensor, or a tuple or list of tensors) as
    fresh meta tensors; None where it cannot be (an aliased, offset or
    oversized storage, or a non-tensor output)."""
    outs = out if isinstance(out, (tuple, list)) else (out,)
    metas = []
    for o in outs:
        if not isinstance(o, torch.Tensor) or o.device.type != "meta":
            return None
        st = o.untyped_storage()
        if (st._cdata in in_keys or o.storage_offset() != 0
                or st.nbytes() != _strided_nbytes(o)):
            return None
        metas.append((tuple(o.shape), o.stride(), o.dtype))
    kind = type(out) if isinstance(out, (tuple, list)) else None
    return kind, metas


def _strided_nbytes(t: torch.Tensor) -> int:
    if t.numel() == 0:
        return 0
    span = 1 + sum((n - 1) * s for n, s in zip(t.shape, t.stride()))
    return span * t.element_size()


def _remake(recipe):
    kind, metas = recipe
    outs = [torch.empty_strided(shape, stride, dtype=dt, device="meta")
            for shape, stride, dt in metas]
    return kind(outs) if kind is not None else outs[0]


ALLOC_BLOCK = 512     # the CUDA caching allocator's rounding of a block


def _blocks(n: int) -> int:
    """``n`` bytes in the allocator's blocks."""
    return -(-n // ALLOC_BLOCK) * ALLOC_BLOCK


def _cumsum_shape(x, dim, dtype=None):
    if dtype is None:      # integers and bools sum in int64
        dtype = x.dtype if (x.is_floating_point() or x.is_complex()) \
            else torch.int64
    return torch.empty_like(x, dtype=dtype)


# meta kernels that do not scale: ``torch._refs.cumsum`` broadcasts an
# [n, n] mask, whose element count overflows int64 past ~3·10⁹ elements;
# on the meta device these ops' outputs are made from their shapes
_SHAPE_RULES = {torch.ops.aten.cumsum.default: _cumsum_shape}


def workspace(name: str, ins: list, outs: list) -> int:
    """Bytes a CUDA kernel of op ``name`` allocates through the caching
    allocator while it runs, beyond its outputs: fitted to
    ``max_memory_allocated`` around single calls on an H100 (torch 2.11,
    rows of 2¹² to 2²⁷ elements; ``tools/workspace_calib.py``).

    * ``cumsum``: CUB's scan tile state, 2 × the output's item size per
      tile of 1,920 (4-byte outputs) or 960 (8-byte) elements, and one
      more block; when the output's dtype is wider than the input's, the
      input's upcast copy (exact to a block at 2²⁷ int32 elements, within
      0.02% for int64).
    * ``sort``: rows of at most 4,096 elements sort in place with 8 bytes
      an element; longer rows take a segmented radix sort: the keys'
      item size plus 16 bytes an element, and a fifth of a byte (within
      0.7% of the measured 20.2–20.3 bytes an int32 key from 2¹⁶ to
      2²⁷).
    Every other op counts none."""
    if not ins or not outs:
        return 0
    x, out = ins[0], outs[0]
    n = x.numel()
    if name == "cumsum":
        per_tile = 1920 if out.element_size() <= 4 else 960
        ws = _blocks(2 * out.element_size() * -(-n // per_tile)) + ALLOC_BLOCK
        if out.element_size() > x.element_size():
            ws += _blocks(n * out.element_size())
        return ws
    if name == "sort":
        row = x.shape[-1] if x.dim() else 1
        if row <= 4096:
            return 8 * n
        return (x.element_size() + 16) * n + n // 5
    return 0


def _steps(n: int) -> int:
    """A lower bound's probes per query over ``n`` keys."""
    return max(1, math.ceil(math.log2(max(2, n))) + 1)


def _search_read(keys: list, n_keys: int, n_queries: int) -> int:
    """Bytes a lower bound reads from ``keys`` (arrays of ``n_keys`` each)
    for ``n_queries`` queries: the probed keys, at most all of them."""
    per_key = sum(k.element_size() for k in keys)
    return min(sum(k.nbytes for k in keys),
               n_queries * _steps(n_keys) * per_key)


class OpCounter(TorchDispatchMode):
    """Count FLOPs, bytes and the live-storage peak of the ops run inside
    the ``with`` block (see the module docstring). ``args`` are the call's
    arguments, live from the start; the storages tracked are those on
    their device (meta without arguments). ``memo=False`` runs every meta
    kernel (the reference the memoized counts are held to)."""

    def __init__(self, args=(), memo: bool = True):
        super().__init__()
        self._memo = {} if memo else None
        self._ops: dict = {}                 # func -> (name, mutable, view)
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        arg_tensors = _tensors(args)
        self.device = (arg_tensors[0].device if arg_tensors
                       else torch.device("meta"))
        self._on_meta = self.device.type == "meta"
        self.flops = 0
        self.bytes_read = 0
        self.bytes_written = 0
        self.n_ops = 0
        self.by_op: dict[str, list] = {}     # name -> [calls, flops, bytes]
        self._live: dict[int, int] = {}      # storage key -> nbytes
        self.live_bytes = 0
        self.peak_bytes = 0
        for t in arg_tensors:
            self._track(t)
        self.argument_bytes = self.live_bytes
        self._arg_keys = set(self._live)

    # --- live storage ---

    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def _track(self, t: torch.Tensor) -> bool:
        """Count ``t``'s storage as live; False if it already was."""
        if t.is_meta != self._on_meta or (
                not self._on_meta and t.device != self.device):
            return False
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return False
        n = _blocks(st.nbytes())
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)
        return True

    # --- bytes of one op ---

    def _op_bytes(self, name: str, mutable: bool, func, args, ins, outs,
                  new_outs) -> tuple[int, int]:
        """(bytes read, bytes written) of one op."""
        if name in _NO_TRAFFIC or (outs and not new_outs and not mutable):
            return 0, 0                       # allocations, views, aliases
        written = sum(o.nbytes for o in outs)
        if name in _GATHERS:
            src = ins[0]
            n_out = sum(o.numel() for o in outs)
            return (min(src.nbytes, n_out * src.element_size())
                    + sum(t.nbytes for t in ins[1:])), written
        if name in _SCATTERS or name in _ACCUMULATING:
            dest, rest = ins[0], ins[1:]
            upd = max((t.numel() for t in rest), default=0) * dest.element_size()
            read = sum(t.nbytes for t in rest)
            if name in _ACCUMULATING:
                read += upd
            if not name.endswith("_"):        # out of place: copy dest
                return read + dest.nbytes, dest.nbytes + upd
            return read, upd
        if name == "searchsorted":
            seq, vals = ins[0], ins[1:]
            n_q = sum(v.numel() for v in vals)
            return (_search_read([seq], seq.shape[-1], n_q)
                    + sum(v.nbytes for v in vals)), written
        if name in _KERNEL_SEARCHES:
            return self._kernel_search(name, ins), written
        if mutable:
            # in place: read every input, write the mutated arguments
            mutated = [a for a, s in zip(args, func._schema.arguments)
                       if isinstance(a, torch.Tensor)
                       and s.alias_info is not None and s.alias_info.is_write]
            return (sum(t.nbytes for t in ins),
                    sum(t.nbytes for t in mutated) or written)
        return sum(t.nbytes for t in ins), written

    @staticmethod
    def _kernel_search(name: str, ins: list) -> int:
        if name == "wedge_check":
            keys, q = ins[:3], ins[3:]        # lo, hi, qd, qh, qi [S, B]
            n_q = q[0].numel()
            return _search_read(keys, keys[0].shape[-1], n_q) + \
                sum(t.nbytes for t in q)
        if name == "wedge_intersect":
            keys, e, rows, ln = ins[:3], ins[3], ins[4:7], ins[7]
            B, Lr = rows[0].shape
            n_cand = e.numel() * max(Lr, 1)
            cand = min(sum(k.nbytes for k in keys),
                       n_cand * sum(k.element_size() for k in keys))
            return (cand + _search_read(rows, Lr, n_cand)
                    + e.nbytes + ln.nbytes)
        rows, ln, q = ins[:3], ins[3], ins[4:]      # intersect
        return (_search_read(rows, rows[0].shape[-1], q[0].numel())
                + ln.nbytes + sum(t.nbytes for t in q))

    # --- dispatch ---

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        info = self._ops.get(func)
        if info is None:
            info = self._ops[func] = (
                func._schema.name.split("::")[-1], func._schema.is_mutable,
                func.is_view, func._overloadpacket in self._flop_registry)
        name, mutable, view, counts_flops = info
        ins = _tensors(args)
        if kwargs:
            _tensors(kwargs, ins)
        for t in ins:
            self._track(t)                    # tensors made before the call
        try:
            out = self._run(func, args, kwargs, ins, mutable or view)
        except Exception as e:
            e.add_note(f"in {func} on {[tuple(t.shape) for t in ins]}")
            raise
        outs = _tensors(out)
        new_outs = [o for o in outs if self._track(o)]
        ws = workspace(name, ins, outs)
        if ws:                                # held while the op ran
            self.peak_bytes = max(self.peak_bytes, self.live_bytes + ws)
        flops = 0
        if counts_flops:
            flops = int(self._flop_registry[func._overloadpacket](
                *args, **kwargs, out_val=out))
        read, written = self._op_bytes(name, mutable, func, args, ins, outs,
                                       new_outs)
        self.n_ops += 1
        self.flops += flops
        self.bytes_read += read
        self.bytes_written += written
        row = self.by_op.setdefault(name, [0, 0, 0])
        row[0] += 1
        row[1] += flops
        row[2] += read + written
        return out

    def _run(self, func, args, kwargs, ins, aliasing: bool):
        """``func(*args, **kwargs)``, or its memoized outputs' remake on the
        meta device (see the module docstring); ``aliasing``: the op is a
        view or writes in place."""
        on_meta = (all(t.is_meta for t in ins) if ins
                   else str(kwargs.get("device")) == "meta")   # factories
        if on_meta and func in _SHAPE_RULES:
            return _SHAPE_RULES[func](*args, **kwargs)
        if self._memo is None or not on_meta or aliasing:
            return func(*args, **kwargs)
        try:
            key = (func, _memo_key(args), _memo_key(kwargs))
            recipe = self._memo.get(key)
        except TypeError:                     # an unhashable argument
            return func(*args, **kwargs)
        if recipe:
            return _remake(recipe)
        out = func(*args, **kwargs)
        if recipe is None:                    # False: not remakeable
            in_keys = {t.untyped_storage()._cdata for t in ins}
            self._memo[key] = _recipe(out, in_keys) or False
        return out

    # --- totals ---

    def result(self, outputs=None, top: int = 12) -> dict:
        """The counts, with the bytes of ``outputs``' storages other than
        the arguments' (the call's output bytes) and the ``top`` ops by
        bytes."""
        keys = {t.untyped_storage()._cdata:
                _blocks(t.untyped_storage().nbytes())
                for t in _tensors(outputs) if t.device == self.device}
        ranked = sorted(self.by_op.items(), key=lambda kv: -kv[1][2])
        return dict(
            flops=self.flops, bytes=self.bytes_read + self.bytes_written,
            bytes_read=self.bytes_read, bytes_written=self.bytes_written,
            n_ops=self.n_ops, peak_bytes=self.peak_bytes,
            argument_bytes=self.argument_bytes,
            output_bytes=sum(n for k, n in keys.items()
                             if k not in self._arg_keys),
            top_ops=[dict(op=k, calls=v[0], flops=v[1], bytes=v[2])
                     for k, v in ranked[:top]])
