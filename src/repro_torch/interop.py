"""Carry state across from the JAX package, given as numpy.

Tests use these to feed the reference's exact shards and plan into the
port's engine (isolating engine parity from host-build parity) and to
compare survey states bit for bit. Nothing here imports the JAX package:
callers hand over plain numpy arrays and dictionaries.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.dodgr import (META_FIELDS, PER_SHARD_FIELDS,
                                    REPLICATED_FIELDS, U32_FIELDS,
                                    ShardedDODGr, dodgr_from_arrays)
from repro_torch.core.engine import EngineConfig
from repro_torch.core.surveys import U32_LEAVES

_ARRAY_FIELDS = PER_SHARD_FIELDS + REPLICATED_FIELDS


def shards_from_arrays(arrays: dict, meta: dict, device) -> ShardedDODGr:
    """``arrays``: every tensor field of ``ShardedDODGr`` as numpy (uint32
    arrays become int32 views); ``meta``: its static fields."""
    missing = [f for f in _ARRAY_FIELDS if f not in arrays]
    missing += [f for f in META_FIELDS if f not in meta]
    if missing:
        raise KeyError(f"shards_from_arrays: missing fields {missing}")
    return dodgr_from_arrays(arrays, meta, device)


def shards_to_arrays(gr: ShardedDODGr) -> tuple[dict, dict]:
    """Inverse of :func:`shards_from_arrays`: numpy arrays (the uint32
    fields as uint32) and the static fields."""
    arrays = {}
    for f in _ARRAY_FIELDS:
        a = getattr(gr, f).cpu().numpy()
        arrays[f] = a.view(np.uint32) if f in U32_FIELDS else a
    return arrays, {f: getattr(gr, f) for f in META_FIELDS}


def _tuplify(x):
    if isinstance(x, (list, tuple, np.ndarray)):
        return tuple(_tuplify(v) for v in x)
    if isinstance(x, np.generic):
        return x.item()
    return x


def engine_config_from_fields(fields: dict) -> EngineConfig:
    """An :class:`EngineConfig` from the reference config's fields (e.g.
    ``dataclasses.asdict``); nested lists become the tuples the engine
    stamps."""
    return EngineConfig(**{k: _tuplify(v) for k, v in fields.items()})


def state_to_numpy(state):
    """A survey state (dict of tensors, or a nested tuple/list of them) as
    numpy, with uint32 leaves (:data:`~repro_torch.core.surveys.U32_LEAVES`)
    viewed as uint32 — the reference's dtypes, so states compare bitwise."""
    if isinstance(state, dict):
        out = {}
        for k, v in state.items():
            if isinstance(v, torch.Tensor):
                a = v.detach().cpu().numpy()
                out[k] = a.view(np.uint32) if k in U32_LEAVES else a
            else:
                out[k] = state_to_numpy(v)
        return out
    if isinstance(state, (list, tuple)):
        return type(state)(state_to_numpy(v) for v in state)
    return state.detach().cpu().numpy()


def _flatten_tree(tree, prefix: str = ""):
    if isinstance(tree, dict):
        for k in tree:
            yield from _flatten_tree(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flatten_tree(v, f"{prefix}{i}.")
    else:
        yield prefix[:-1], tree


def gnn_params_from_jax(tree: dict, device) -> dict:
    """A GNN parameter tree of the JAX package (SchNet, DimeNet, NequIP or
    EquiformerV2: nested dicts and lists of numpy arrays, as
    ``jax.tree.map(np.asarray, params)`` gives it) as a state dict for the
    port's module (:class:`~repro_torch.models.layers.ParamTree`:
    ``model.load_state_dict(...)``): each array copied, float32, on
    ``device``, under its path in the tree (``blocks.0.filt1.w``,
    ``layers.1.so2.2.wi``)."""
    return {name: torch.tensor(np.asarray(a, np.float32), device=device)
            for name, a in _flatten_tree(tree)}


schnet_params_from_jax = gnn_params_from_jax


def params_to_numpy(params):
    """A parameter tree (nested dicts and lists of tensors, or a module
    with a ``tree()``: ``SchNet``, ``DimeNet``, ``NequIP``,
    ``EquiformerV2``) as numpy, in the layout ``jax.tree.map(np.asarray,
    params)`` gives the reference's — the inverse of
    :func:`gnn_params_from_jax`, for comparing weights."""
    if hasattr(params, "tree"):
        params = params.tree()
    if isinstance(params, dict):
        return {k: params_to_numpy(v) for k, v in params.items()}
    if isinstance(params, (list, tuple)):
        return [params_to_numpy(v) for v in params]
    return params.detach().cpu().numpy()
