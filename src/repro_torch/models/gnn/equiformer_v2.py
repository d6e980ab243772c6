"""EquiformerV2 [arXiv:2306.12059]: eSCN-style SO(2) graph attention.

The twin of ``repro.models.gnn.equiformer_v2``. Brief config:
n_layers=12, d_hidden=128, l_max=6, m_max=2, n_heads=8, equivariance =
SO(2)-eSCN. Per edge, source irreps are rotated into the edge-aligned
frame (Wigner-D, ``so3.rotation_to_z``), where the full O(L⁶) tensor
product collapses to independent per-m SO(2) linear maps with |m| ≤ m_max
(O(L³)); messages rotate back and aggregate under attention whose logits
come from the rotation-invariant m=0 components. The S2 pointwise
activation of the original is simplified to a gated nonlinearity, as in
the reference.

Attention has the reference's two paths: the whole-edge segment softmax
(``edge_chunks == 1``, or a count that does not divide |E|), and the
streaming one over ``edge_chunks`` chunks with a running max,
denominator and accumulator per node (the reference's ``lax.scan``, here
a Python loop), so per-edge transients never materialize at full |E|.
Nodes with no incoming edge keep a max of −inf, as ``jax.ops.
segment_max`` gives (``common.segment_max``). The per-edge rotations
depend on positions only, so they are computed once per forward and
sliced per chunk; the reference recomputes the same values in every
layer. Where the reference writes
into zeros with ``.at[].set`` / ``.add`` / ``.multiply``, the port
concatenates fresh blocks.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import threefry
from repro_torch.models.gnn import so3
from repro_torch.models.gnn.common import (
    GraphBatch,
    bessel_rbf,
    cosine_cutoff,
    edge_vectors,
    segment_max,
    segment_sum,
)
from repro_torch.models.layers import ParamTree, truncated_normal
from repro_torch.utils import resolve_device


def _dense(key, din, dout):
    return dict(w=truncated_normal(key, (din, dout), 1.0 / np.sqrt(din)),
                b=torch.zeros(dout, dtype=torch.float32))


def _apply(p, x):
    return x @ p["w"] + p["b"]


def _m_groups(l_max: int, m_max: int):
    """Rows of the (l_max+1)² irrep vector participating per |m| ≤ m_max.

    Returns dict m → (rows_pos, rows_neg); for m=0 rows_neg is None.
    Row index of (l, m) in the concatenated layout is l² + l + m.
    """
    groups = {}
    for m in range(0, m_max + 1):
        pos = [l * l + l + m for l in range(max(m, 0), l_max + 1) if m <= l]
        if m == 0:
            groups[0] = (np.array(pos), None)
        else:
            neg = [l * l + l - m for l in range(m, l_max + 1)]
            groups[m] = (np.array(pos), np.array(neg))
    return groups


@dataclass(frozen=True)
class Cfg:
    n_layers: int = 12
    channels: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 32
    d_feat: int = 0
    d_out: int = 1
    # >1: process edges in this many chunks with streaming segment-softmax
    # (flash-attention-style running (max, denom, acc) per node) so per-edge
    # transients (rotations, messages) never materialize at full |E|.
    edge_chunks: int = 1


def init_params(key, cfg: Cfg) -> dict:
    """A parameter tree on the CPU from a threefry key, split and consumed
    in the reference's order."""
    n_layers, channels, l_max, m_max = cfg.n_layers, cfg.channels, cfg.l_max, cfg.m_max
    n_heads, n_rbf = cfg.n_heads, cfg.n_rbf
    n_species, d_feat, d_out = cfg.n_species, cfg.d_feat, cfg.d_out
    groups = _m_groups(l_max, m_max)
    ks = iter(threefry.split(key, n_layers * (3 + 3 * len(groups)) + 8))
    p = dict(layers=[])
    if d_feat:
        p["embed"] = _dense(next(ks), d_feat, channels)
    else:
        p["embed"] = dict(w=truncated_normal(next(ks), (n_species, channels),
                                             1.0))
    for _ in range(n_layers):
        layer = dict(radial=_dense(next(ks), n_rbf, channels),
                     alpha=_dense(next(ks), len(groups[0][0]) * channels, n_heads),
                     so2={}, ffn1=_dense(next(ks), channels, channels * 2),
                     ffn2=_dense(next(ks), channels * 2, channels),
                     gates=_dense(next(ks), channels, channels * l_max))
        for m, (pos, neg) in groups.items():
            n_l = len(pos)
            sc = 1.0 / np.sqrt(n_l * channels)
            shape = (n_l * channels, n_l * channels)
            layer["so2"][str(m)] = dict(wr=truncated_normal(next(ks), shape, sc))
            if m:
                layer["so2"][str(m)]["wi"] = truncated_normal(next(ks), shape, sc)
        p["layers"].append(layer)
    p["head1"] = _dense(next(ks), channels, channels)
    p["head2"] = _dense(next(ks), channels, d_out)
    return p


def _equiv_norm(x, l_max):
    """RMS norm per l-block over (m, channels)."""
    outs = []
    for l, (a, b) in enumerate(so3.l_slices(l_max)):
        blk = x[:, a:b, :]
        rms = torch.sqrt(torch.mean(blk * blk, dim=(1, 2), keepdim=True) + 1e-6)
        outs.append(blk / rms)
    return torch.cat(outs, 1)


def _so2_rows(groups, n_irr: int):
    """Where each irrep row of :func:`_so2_conv`'s output lies in the
    concatenation of its groups' outputs (m = 0, then each m's + and −
    rows) and a trailing zero row (rows with |m| > m_max)."""
    order = [r for m, (pos, neg) in groups.items()
             for rows in ((pos,) if m == 0 else (pos, neg)) for r in rows]
    where = np.full(n_irr, len(order))
    where[order] = np.arange(len(order))
    return torch.as_tensor(where)


def _so2_conv(layer, groups, x_rot, rad, where):
    """Per-m SO(2) linear maps in the edge frame. x_rot [e, (L+1)², C];
    ``groups``' rows and ``where`` (:func:`_so2_rows`) as device tensors."""
    e, n_irr, C = x_rot.shape
    outs = []
    for m, (pos, neg) in groups.items():
        wp = layer["so2"][str(m)]
        xp = (x_rot[:, pos, :] * rad[:, None, :]).reshape(e, -1)
        if m == 0:
            outs.append((xp @ wp["wr"]).reshape(e, len(pos), C))
        else:
            xn = (x_rot[:, neg, :] * rad[:, None, :]).reshape(e, -1)
            yp = xp @ wp["wr"] - xn @ wp["wi"]
            yn = xp @ wp["wi"] + xn @ wp["wr"]
            outs += [yp.reshape(e, len(pos), C), yn.reshape(e, len(pos), C)]
    outs.append(x_rot.new_zeros((e, 1, C)))
    return torch.cat(outs, 1)[:, where]


def forward(cfg: Cfg, p, g: GraphBatch):
    """→ (node_out [N, d_out], graph_out [n_graphs, d_out])."""
    l_max, m_max, C = cfg.l_max, cfg.m_max, cfg.channels
    H = cfg.n_heads
    groups = _m_groups(l_max, m_max)
    n_irr = so3.irreps_dim(l_max)
    N = g.positions.shape[0]
    E = g.edge_src.shape[0]

    if g.node_feat is not None:
        scal = _apply(p["embed"], g.node_feat)
    else:
        scal = p["embed"]["w"][g.species.long()]
    x = torch.cat([scal[:, None, :], scal.new_zeros((N, n_irr - 1, C))], 1)

    _, d, unit = edge_vectors(g)
    rbf = bessel_rbf(d, cfg.n_rbf, cfg.cutoff) * cosine_cutoff(d, cfg.cutoff)[:, None]
    sl = so3.l_slices(l_max)
    # the row indices on the device once: a host index array would be
    # copied (and the stream synchronized) at every use
    dev = x.device
    rows = {m: tuple(None if r is None else torch.as_tensor(r, device=dev)
                     for r in pn) for m, pn in groups.items()}
    where = _so2_rows(groups, n_irr).to(dev)
    m0_rows = rows[0][0]
    src_all, dst_all = g.edge_src.long(), g.edge_dst.long()
    rot_all = [so3.rotation_to_z(l, unit) for l in range(l_max + 1)]

    nb = max(1, cfg.edge_chunks)
    if E % nb:
        nb = 1
    blk = E // nb
    chunks = []
    for i in range(nb):
        s = slice(i * blk, (i + 1) * blk)
        chunks.append(dict(src=src_all[s], dst=dst_all[s],
                           valid=g.edge_valid[s], rbf=rbf[s],
                           rot=[r[s] for r in rot_all]))

    def rotate(rot, feats_e, transpose):
        eq = "eba,ebc->eac" if transpose else "eab,ebc->eac"
        return torch.cat([torch.einsum(eq, rot[l], feats_e[:, a:b, :])
                          for l, (a, b) in enumerate(sl)], 1)

    def edge_messages(layer, xn, c):
        """Per-edge-chunk: rotate → SO(2) conv → rotate back → logits."""
        e = c["src"].shape[0]
        rad = F.silu(_apply(layer["radial"], c["rbf"]))     # [e, C]
        src = xn[c["src"]]                                   # [e, n_irr, C]
        x_rot = rotate(c["rot"], src, transpose=False)
        msg_rot = _so2_conv(layer, rows, x_rot, rad, where)
        msg = rotate(c["rot"], msg_rot, transpose=True)
        inv = msg_rot[:, m0_rows, :].reshape(e, -1)
        logits = _apply(layer["alpha"], inv)                 # [e, H]
        logits = torch.where(c["valid"][:, None], logits, -1e30)
        return msg, logits

    def attention_agg(layer, xn):
        """Segment-softmax attention over incoming edges; in streaming
        chunks (running max/denominator/accumulator per node) when
        ``edge_chunks`` divides |E|."""
        if nb == 1:
            c = chunks[0]
            msg, logits = edge_messages(layer, xn, c)
            ev = c["valid"].to(logits.dtype)
            mx = segment_max(logits, c["dst"], N)
            w = torch.exp(logits - mx[c["dst"]]) * ev[:, None]
            den = segment_sum(w, c["dst"], N)
            w = w / torch.clamp_min(den[c["dst"]], 1e-30)
            mh = msg.reshape(E, n_irr, H, C // H) * w[:, None, :, None]
            return segment_sum(mh.reshape(E, n_irr, C), c["dst"], N)

        m = xn.new_full((N, H), -1e30)
        l = xn.new_zeros((N, H))
        acc = xn.new_zeros((N, n_irr, H, C // H))
        for c in chunks:
            msg, logits = edge_messages(layer, xn, c)
            cm = segment_max(logits, c["dst"], N)
            m_new = torch.maximum(m, cm)
            corr = torch.exp(m - m_new)
            wexp = torch.exp(logits - m_new[c["dst"]]) * c["valid"][:, None]
            l = l * corr + segment_sum(wexp, c["dst"], N)
            mh = msg.reshape(blk, n_irr, H, C // H) * wexp[:, None, :, None]
            acc = acc * corr[:, None, :, None] + segment_sum(mh, c["dst"], N)
            m = m_new
        out = acc / torch.clamp_min(l[:, None, :, None], 1e-30)
        # zero out nodes with no incoming edges (l == 0)
        out = out * (l[:, None, :, None] > 0)
        return out.reshape(N, n_irr, C)

    for layer in p["layers"]:
        xn = _equiv_norm(x, l_max)
        x = x + attention_agg(layer, xn)
        # gated FFN on scalars, gates modulate l>0 blocks
        s = x[:, 0, :]
        h = _apply(layer["ffn2"], F.silu(_apply(layer["ffn1"], s)))
        gates = torch.sigmoid(_apply(layer["gates"], s)).reshape(N, l_max, C)
        x = torch.cat([x[:, :1, :] + h[:, None, :]]
                      + [x[:, a:b, :] * gates[:, l - 1][:, None, :]
                         for l, (a, b) in enumerate(sl) if l], 1)

    node = _apply(p["head2"], F.silu(_apply(p["head1"], x[:, 0, :])))
    node = node * g.node_valid[:, None]
    graph = segment_sum(node, g.graph_id, g.n_graphs)
    return node, graph


class EquiformerV2(ParamTree):
    """EquiformerV2 as a module: ``forward(g)`` → ``(node_out,
    graph_out)``; weights as :class:`~repro_torch.models.gnn.dimenet.
    DimeNet`'s."""

    def __init__(self, cfg: Cfg, params: dict | None = None, *, key=None,
                 device=None):
        super().__init__(init_params(threefry.prng_key(0) if key is None
                                     else key, cfg)
                         if params is None else params)
        self.cfg = cfg
        self.to(resolve_device(device))

    def forward(self, g: GraphBatch):
        return forward(self.cfg, self.tree(), g)
