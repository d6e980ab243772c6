"""Edge-list persistence: npz with metadata columns and the column names.

``save_delta``/``load_delta`` persist an epoch-aware :class:`DeltaGraph`
(immutable base, compact overlay, epoch counter) so a streaming survey can
checkpoint between batches and resume with its provenance. The files hold
the JAX package's fields under its names, so a file written by one package
loads in the other to equal arrays.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.csr import DeltaGraph, HostGraph, MetaSpec


def _spec_fields(spec: MetaSpec) -> dict:
    """MetaSpec → npz fields (NUL-joined column-name lists)."""
    return dict(
        v_int="\x00".join(spec.v_int), v_float="\x00".join(spec.v_float),
        e_int="\x00".join(spec.e_int), e_float="\x00".join(spec.e_float))


def _spec_from_npz(z) -> MetaSpec:
    names = lambda k: tuple(x for x in str(z[k]).split("\x00") if x)
    return MetaSpec(v_int=names("v_int"), v_float=names("v_float"),
                    e_int=names("e_int"), e_float=names("e_float"))


def _graph_fields(g: HostGraph) -> dict:
    return dict(n=g.n, src=g.src, dst=g.dst,
                vmeta_i=g.vmeta_i, vmeta_f=g.vmeta_f,
                emeta_i=g.emeta_i, emeta_f=g.emeta_f,
                **_spec_fields(g.spec))


def _graph_from_npz(z, **stamp) -> HostGraph:
    return HostGraph(n=int(z["n"]), src=z["src"], dst=z["dst"],
                     spec=_spec_from_npz(z),
                     vmeta_i=z["vmeta_i"], vmeta_f=z["vmeta_f"],
                     emeta_i=z["emeta_i"], emeta_f=z["emeta_f"], **stamp)


def _delta_fields(dg: DeltaGraph) -> dict:
    return dict(**_graph_fields(dg.base), d_src=dg.d_src, d_dst=dg.d_dst,
                d_emeta_i=dg.d_emeta_i, d_emeta_f=dg.d_emeta_f,
                epoch=dg.epoch)


def _delta_from_npz(z, base: HostGraph) -> DeltaGraph:
    return DeltaGraph(base=base, d_src=z["d_src"], d_dst=z["d_dst"],
                      d_emeta_i=z["d_emeta_i"], d_emeta_f=z["d_emeta_f"],
                      epoch=int(z["epoch"]))


def save_graph(path: str, g: HostGraph):
    np.savez_compressed(path, **_graph_fields(g))


def load_graph(path: str) -> HostGraph:
    return _graph_from_npz(np.load(path, allow_pickle=False))


def save_delta(path: str, dg: DeltaGraph):
    np.savez_compressed(path, **_delta_fields(dg))


def load_delta(path: str) -> DeltaGraph:
    z = np.load(path, allow_pickle=False)
    return _delta_from_npz(z, _graph_from_npz(z))


def save_epoch_state(path: str, dg: DeltaGraph, token: str = ""):
    """Serving checkpoint: a :func:`save_delta` payload plus the content
    token chain and the base's DOULION stamp, so a restored service
    derives the same plan content keys it would have without the
    restart."""
    np.savez_compressed(path, **_delta_fields(dg), token=token,
                        sample_p=dg.base.sample_p,
                        sample_seed=dg.base.sample_seed)


def load_epoch_state(path: str) -> tuple[DeltaGraph, str]:
    z = np.load(path, allow_pickle=False)
    base = _graph_from_npz(z, sample_p=float(z["sample_p"]),
                           sample_seed=int(z["sample_seed"]))
    return _delta_from_npz(z, base), str(z["token"])
