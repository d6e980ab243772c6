"""Content-keyed LRU cache over (plan, shards, survey function) triplets.

A :class:`CacheEntry` bundles everything the engine needs to answer one
survey against one graph epoch: the planned
:class:`~repro_torch.core.engine.EngineConfig` and its
:class:`~repro_torch.core.pushpull.VolumeReport`, the sharded graph
(``ShardedDODGr``, hub tables included, on the service's device), the
survey function, and the raw ``(merged_state, stats)`` of the warm-up
traversal, so an exact repeat query is answered by finalizing alone.

Keys are :func:`repro_torch.core.pushpull.plan_content_key` digests: any
change in (graph token and epoch, survey parameters and MetaSpec,
transport, hub θ, S, sampling, cap policy) gives another key. Eviction is
least-recently-used under a byte budget over the entries' shard tensors
(:func:`entry_nbytes`, the JAX package's count for the same shards). The
newest entry is never evicted by its own insertion.

Entries persist across processes and across packages:
:func:`save_plan_cache` writes one ``.npz`` of named arrays and a JSON
manifest (no pickle) in the JAX package's format, and
:func:`load_plan_cache` rebuilds the entries from a file of either
package. uint32 lanes (the shards' hashes, the counting tables and the
counter limbs) are written as uint32 arrays and read back as int32 bits;
the memo's stats are written as 0-d float32 arrays. The survey function
and the ``Survey`` instance are not persisted (``fn=None``,
``survey=None``); the service attaches both at the first hit. A key names
the survey's classes, which differ by package, so a service hits the
entries its own package wrote.
"""
from __future__ import annotations

import json
import threading
from collections import OrderedDict
from dataclasses import asdict, dataclass, fields
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core.dodgr import META_FIELDS, dodgr_from_arrays
from repro_torch.core.engine import EngineConfig
from repro_torch.core.pushpull import VolumeReport
from repro_torch.core.surveys import U32_LEAVES
from repro_torch.interop import shards_to_arrays
from repro_torch.utils import resolve_device


def entry_nbytes(gr: Any) -> int:
    """Total bytes of the tensor fields of a sharded view."""
    total = 0
    for f in fields(gr):
        t = getattr(gr, f.name)
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


@dataclass
class CacheEntry:
    """Everything needed to re-answer one (survey, graph-epoch) pair.

    ``survey`` and ``fn`` are ``None`` on entries restored by
    :func:`load_plan_cache`; the serving layer fills both in on the first
    hit. ``survey_fp`` carries the fingerprint across the boundary."""

    key: str
    survey: Any = None              # canonical Survey instance the fn folds
    cfg: Any = None                 # EngineConfig
    report: Any = None              # VolumeReport
    gr: Any = None                  # ShardedDODGr (shards on the device)
    fn: Callable[[Any], Any] | None = None  # the survey function
    raw: Any = None                 # (merged_state, stats) of warm-up run
    nbytes: int = 0
    uses: int = 0
    survey_fp: str = ""             # survey_fingerprint (persistence sanity)


@dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0

    def as_dict(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "evictions": self.evictions}


class PlanCache:
    """LRU plan cache with byte-budget eviction.

    Thread-safe: query threads look plans up while the ingest worker
    inserts."""

    def __init__(self, byte_budget: int | None = None):
        self.byte_budget = byte_budget
        self._entries: OrderedDict[str, CacheEntry] = OrderedDict()
        self._lock = threading.Lock()
        self._stats = CacheStats()

    def lookup(self, key: str) -> CacheEntry | None:
        with self._lock:
            entry = self._entries.get(key)
            if entry is None:
                self._stats.misses += 1
                return None
            self._entries.move_to_end(key)
            self._stats.hits += 1
            entry.uses += 1
            return entry

    def peek(self, key: str) -> CacheEntry | None:
        """Lookup without touching LRU order or hit/miss counters."""
        with self._lock:
            return self._entries.get(key)

    def insert(self, entry: CacheEntry) -> CacheEntry:
        with self._lock:
            self._entries[entry.key] = entry
            self._entries.move_to_end(entry.key)
            self._evict_locked(keep=entry.key)
            return entry

    def invalidate(self, key: str) -> bool:
        with self._lock:
            return self._entries.pop(key, None) is not None

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def _evict_locked(self, keep: str | None = None) -> None:
        if self.byte_budget is None:
            return
        while self.nbytes_locked() > self.byte_budget and len(self._entries) > 1:
            oldest = next(iter(self._entries))
            if oldest == keep:
                # the newest entry alone exceeds the budget: keep it until
                # the next insert
                break
            self._entries.pop(oldest)
            self._stats.evictions += 1

    def nbytes_locked(self) -> int:
        return sum(e.nbytes for e in self._entries.values())

    @property
    def nbytes(self) -> int:
        with self._lock:
            return self.nbytes_locked()

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: str) -> bool:
        return key in self._entries

    def keys(self) -> list:
        with self._lock:
            return list(self._entries)

    def stats(self) -> dict:
        with self._lock:
            d = self._stats.as_dict()
            d["entries"] = len(self._entries)
            d["bytes"] = self.nbytes_locked()
            d["byte_budget"] = self.byte_budget
            return d


# ---------------------------------------------------------------------------
# persistence (no pickle: JSON manifest + named npz arrays)

_PLANS_VERSION = 1


def _json_default(o):
    """Planner arithmetic may stamp numpy scalars; JSON them as Python
    values."""
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.bool_):
        return bool(o)
    raise TypeError(f"not JSON-serializable: {type(o)}")


def _leaf_array(x, u32: bool) -> np.ndarray:
    """A state leaf as the JAX package stores it: uint32 lanes (state
    leaves named in ``U32_LEAVES``) as uint32."""
    a = x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.uint32) if u32 and a.dtype == np.int32 else a


def _encode_tree(obj, arrays: dict, prefix: str, counter: list,
                 u32: bool = False) -> Any:
    """JSON-able spec of a (dict/tuple/list/tensor/scalar) tree; tensor
    leaves are hoisted into ``arrays`` under generated names."""
    if obj is None:
        return {"t": "none"}
    if isinstance(obj, (bool, int, float, str)):
        return {"t": "py", "v": obj}
    if isinstance(obj, dict):
        keys = list(obj.keys())
        if not all(isinstance(k, str) for k in keys):
            raise TypeError("persisted state dicts must have str keys")
        keys.sort()   # the JAX package's order: its pytrees sort dict keys
        return {"t": "dict", "k": keys,
                "v": [_encode_tree(obj[k], arrays, prefix, counter,
                                   k in U32_LEAVES) for k in keys]}
    if isinstance(obj, (tuple, list)):
        return {"t": "tuple" if isinstance(obj, tuple) else "list",
                "v": [_encode_tree(x, arrays, prefix, counter) for x in obj]}
    arr = _leaf_array(obj, u32)
    if arr.dtype == object:
        raise TypeError(f"cannot persist object-dtype leaf {type(obj)}")
    name = f"{prefix}{counter[0]}"
    counter[0] += 1
    arrays[name] = arr
    return {"t": "arr", "n": name}


def _decode_tree(spec, z, device) -> Any:
    t = spec["t"]
    if t == "none":
        return None
    if t == "py":
        return spec["v"]
    if t == "dict":
        return {k: _decode_tree(v, z, device)
                for k, v in zip(spec["k"], spec["v"])}
    if t == "tuple":
        return tuple(_decode_tree(v, z, device) for v in spec["v"])
    if t == "list":
        return [_decode_tree(v, z, device) for v in spec["v"]]
    if t == "arr":
        a = np.array(z[spec["n"]])
        if a.dtype == np.uint32:
            a = a.view(np.int32)
        return torch.as_tensor(a, device=device)
    raise ValueError(f"unknown persisted-tree tag {t!r}")


def _raw_for_file(raw):
    """The memo as the JAX package holds it: stats as 0-d float32."""
    state, stats = raw
    return state, {k: np.float32(v) for k, v in stats.items()}


def _raw_from_file(raw):
    """The memo as the port holds it: stats as Python floats."""
    state, stats = raw
    return state, {k: float(v) for k, v in stats.items()}


def _tuplify(x):
    """JSON round-trips tuples as lists; restore nested tuples."""
    if isinstance(x, list):
        return tuple(_tuplify(v) for v in x)
    return x


def save_plan_cache(path, cache: PlanCache) -> int:
    """Persist every cache entry to one ``.npz``: content key, config,
    report, shards, memoized warm-up state and survey fingerprint, in the
    JAX package's format. Returns the number of entries written."""
    arrays: dict = {}
    manifest: dict = {"version": _PLANS_VERSION, "entries": []}
    with cache._lock:
        entries = list(cache._entries.values())
    for i, e in enumerate(entries):
        gr_np, gr_meta = shards_to_arrays(e.gr)
        gr_arrays = {}
        for f, a in gr_np.items():
            name = f"e{i}_gr_{f}"
            arrays[name] = a
            gr_arrays[f] = name
        raw_spec = (None if e.raw is None else
                    _encode_tree(_raw_for_file(e.raw), arrays, f"e{i}_raw_",
                                 [0]))
        manifest["entries"].append({
            "key": e.key,
            "survey_fp": e.survey_fp or "",
            "nbytes": int(e.nbytes),
            "uses": int(e.uses),
            "cfg": asdict(e.cfg),
            "report": asdict(e.report),
            "gr_meta": gr_meta,
            "gr_arrays": gr_arrays,
            "raw": raw_spec,
        })
    np.savez_compressed(
        path, manifest=np.asarray(json.dumps(manifest, default=_json_default)),
        **arrays)
    return len(entries)


def load_plan_cache(path, into: PlanCache | None = None,
                    device=None) -> list[CacheEntry]:
    """Rebuild the :class:`CacheEntry` objects of a file written by
    :func:`save_plan_cache` of either package, their tensors on
    ``device`` (``None``: the card, as ``resolve_device``); ``fn`` and
    ``survey`` are ``None``. ``into`` also inserts each entry into a
    cache, oldest first, so LRU order is kept. Returns the entries."""
    dev = resolve_device(device)
    out: list[CacheEntry] = []
    with np.load(path, allow_pickle=False) as z:
        manifest = json.loads(str(z["manifest"]))
        if manifest.get("version") != _PLANS_VERSION:
            raise ValueError(
                f"plan-cache file version {manifest.get('version')} != "
                f"{_PLANS_VERSION}")
        for m in manifest["entries"]:
            cfg_d = dict(m["cfg"])
            for f in ("meta_widths", "push_caps", "pull_caps"):
                cfg_d[f] = _tuplify(cfg_d.get(f))
            gr = dodgr_from_arrays(
                {f: z[name] for f, name in m["gr_arrays"].items()},
                {f: m["gr_meta"][f] for f in META_FIELDS}, dev)
            raw = (None if m["raw"] is None else
                   _raw_from_file(_decode_tree(m["raw"], z, dev)))
            entry = CacheEntry(
                key=m["key"], survey=None, cfg=EngineConfig(**cfg_d),
                report=VolumeReport(**m["report"]), gr=gr, fn=None, raw=raw,
                nbytes=int(m["nbytes"]), uses=int(m["uses"]),
                survey_fp=m.get("survey_fp", ""))
            out.append(entry)
            if into is not None:
                into.insert(entry)
    return out
