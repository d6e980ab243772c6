"""DimeNet [arXiv:2003.03123]: directional message passing on edges.

The twin of ``repro.models.gnn.dimenet``. Brief config: n_blocks=6,
d_hidden=128, n_bilinear=8, n_spherical=7, n_radial=6. Messages live on
directed edges; interactions gather over triplets (k→j→i) with a 2D
spherical-Bessel × angular basis. The triplet index lists come from the
host (``common.build_triplets``), padded static. The bilinear contraction
uses the DimeNet++-style down-project (n_bilinear) form.

The host helpers (:func:`_spherical_jn_np`, :func:`bessel_roots`) are the
reference's numpy code, copied. :func:`_spherical_jn_all` computes the
three regimes the reference computes (small-x series, Miller downward
recursion, upward recursion) with its branch points and its float
operations in its order, then selects by ``where``; everything computes
in the dtype of its input. Parameters, ``forward`` and the module follow
``schnet.py``: a tree of the reference's layout, a functional forward,
and :class:`DimeNet` holding the tree as named parameters.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models import threefry
from repro_torch.models.gnn.common import (
    GraphBatch,
    _integer_pow,
    bessel_rbf,
    edge_vectors,
    polynomial_cutoff,
    segment_mp,
    segment_sum,
)
from repro_torch.models.layers import ParamTree, truncated_normal
from repro_torch.utils import resolve_device

# ---------------------------------------------------------------------------
# spherical Bessel basis


def _spherical_jn_np(l: int, x: np.ndarray) -> np.ndarray:
    """j_l(x) host reference: Miller downward recursion in float64
    (stable for all x; upward recursion diverges for x < l)."""
    x = np.atleast_1d(np.asarray(x, np.float64))
    tiny = np.abs(x) < 1e-6
    xs = np.where(tiny, 1.0, x)
    # Miller start order must exceed both l and the largest argument
    M = l + 30 + int(np.ceil(float(np.abs(x).max())))
    jp = np.zeros_like(xs)
    jc = np.full_like(xs, 1e-30)
    want = None
    for ll in range(M, 0, -1):
        jm = (2 * ll + 1) / xs * jc - jp
        jp, jc = jc, jm
        if ll - 1 == l:
            want = jc
        # renormalize to avoid overflow
        big = np.abs(jc) > 1e250
        if big.any():
            jc = np.where(big, jc * 1e-200, jc)
            jp = np.where(big, jp * 1e-200, jp)
            if want is not None:
                want = np.where(big, want * 1e-200, want)
    if l == 0:
        want = jc
    # Normalize by a closed-form order: j0 = sin(x)/x, or j1 where x sits at
    # a root of j0 (there jc cancels to exactly 0 and j0/jc is 0/0; j0 and j1
    # have no common roots, and jp is the unnormalized j1).
    j0_true = np.sin(xs) / np.where(tiny, 1.0, xs)
    j1_true = np.sin(xs) / xs**2 - np.cos(xs) / xs
    use_j1 = np.abs(j0_true) < 1e-8
    denom = np.where(use_j1, jp, jc)
    scale = np.where(use_j1, j1_true, j0_true) / np.where(denom == 0, 1.0, denom)
    out = want * scale
    return np.where(tiny, 1.0 if l == 0 else 0.0, out)


@lru_cache(maxsize=None)
def bessel_roots(n_spherical: int, n_radial: int) -> tuple:
    """First n_radial positive roots of j_l, l < n_spherical (host bisection)."""
    out = np.zeros((n_spherical, n_radial))
    for l in range(n_spherical):
        xs = np.linspace(1e-3, (n_radial + l + 2) * np.pi, 20000)
        ys = _spherical_jn_np(l, xs)
        sign = np.signbit(ys)
        idx = np.nonzero(sign[1:] != sign[:-1])[0]
        roots = []
        for i in idx[: n_radial + 2]:
            a, b = xs[i], xs[i + 1]
            for _ in range(60):
                m = 0.5 * (a + b)
                if np.signbit(_spherical_jn_np(l, np.array(m))) == np.signbit(
                        _spherical_jn_np(l, np.array(a))):
                    a = m
                else:
                    b = m
            roots.append(0.5 * (a + b))
        out[l] = roots[:n_radial]
    return tuple(map(tuple, out))


def _spherical_jn_all(l_max: int, x: torch.Tensor) -> list:
    """j_l(x) for 0 ≤ l ≤ l_max, stable for all x ≥ 0 (the reference's
    ``_spherical_jn_all_jnp``).

    Upward recursion is catastrophically unstable for x < l; Miller's
    downward recursion normalized by j₀ = sin(x)/x covers the middle,
    upward recursion x ≥ l_max + 2, and a two-term Taylor series below
    x = 0.5 (j_l(x) ≈ xˡ/(2l+1)!! · (1 − x²/(2(2l+3)))). Returns a list
    of tensors.
    """
    small = x < 0.5
    big = x >= l_max + 2.0          # upward recursion is stable for x > l
    xs = torch.where(small, 1.0, x)
    # downward (Miller) recursion for the middle regime
    M = l_max + 16
    jp = torch.zeros_like(xs)
    jc = torch.full_like(xs, 1e-8)
    down = [None] * (l_max + 1)
    for ll in range(M, 0, -1):
        jm = (2 * ll + 1) / xs * jc - jp
        jp, jc = jc, jm
        if ll - 1 <= l_max:
            down[ll - 1] = jc
    scale = (torch.sin(xs) / xs) / jc          # jc == unnormalized j0
    # upward recursion for the oscillatory regime
    up = [torch.sin(xs) / xs]
    if l_max >= 1:
        up.append(torch.sin(xs) / _integer_pow(xs, 2) - torch.cos(xs) / xs)
    for ll in range(1, l_max):
        up.append((2 * ll + 1) / xs * up[ll] - up[ll - 1])
    dfact = 1.0
    out = []
    for l in range(l_max + 1):
        if l > 0:
            dfact *= (2 * l + 1)
        xl = _integer_pow(x, l) if l else torch.ones_like(x)
        series = xl / dfact * (1.0 - x * x / (2.0 * (2 * l + 3)))
        mid = down[l] * scale
        val = torch.where(big, up[l], mid)
        out.append(torch.where(small, series, val))
    return out


def _legendre_m0(n_spherical: int, ct: torch.Tensor) -> torch.Tensor:
    """P_l(cosθ) for l < n_spherical."""
    out = [torch.ones_like(ct)]
    if n_spherical > 1:
        out.append(ct)
    for l in range(2, n_spherical):
        out.append(((2 * l - 1) * ct * out[-1] - (l - 1) * out[-2]) / l)
    return torch.stack(out, -1)


def spherical_basis(d_kj, angle_cos, cutoff, n_spherical, n_radial):
    """a_SBF [T, n_spherical · n_radial]."""
    roots = torch.as_tensor(np.asarray(bessel_roots(n_spherical, n_radial)),
                            dtype=d_kj.dtype, device=d_kj.device)  # [S, R]
    x = d_kj / cutoff
    args = roots[None, :, :] * x[:, None, None]              # [T, S, R]
    jl_all = _spherical_jn_all(n_spherical - 1, args.reshape(-1))
    radial = torch.stack([jl_all[l].reshape(args.shape)[:, l, :]
                          for l in range(n_spherical)], 1)   # [T, S, R]
    ang = _legendre_m0(n_spherical, angle_cos)               # [T, S]
    env = polynomial_cutoff(d_kj, cutoff)[:, None, None]
    return (radial * ang[:, :, None] * env).reshape(d_kj.shape[0], -1)


# ---------------------------------------------------------------------------
# model


def _dense(key, din, dout, bias=True):
    p = dict(w=truncated_normal(key, (din, dout), 1.0 / np.sqrt(din)))
    if bias:
        p["b"] = torch.zeros(dout, dtype=torch.float32)
    return p


def _apply(p, x):
    y = x @ p["w"]
    return y + p["b"] if "b" in p else y


@dataclass(frozen=True)
class Cfg:
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    cutoff: float = 5.0
    n_species: int = 32
    d_feat: int = 0
    d_out: int = 1


def init_params(key, cfg: Cfg) -> dict:
    """A parameter tree on the CPU, drawn from a
    :mod:`~repro_torch.models.threefry` key split and consumed in the
    reference's order: the reference's weights, within float32 rounding."""
    n_blocks, d_hidden, n_bilinear = cfg.n_blocks, cfg.d_hidden, cfg.n_bilinear
    n_spherical, n_radial = cfg.n_spherical, cfg.n_radial
    n_species, d_feat, d_out = cfg.n_species, cfg.d_feat, cfg.d_out
    ks = iter(threefry.split(key, 8 * n_blocks + 10))
    n_sbf = n_spherical * n_radial
    p = dict(blocks=[])
    if d_feat:
        p["embed"] = _dense(next(ks), d_feat, d_hidden)
    else:
        p["embed"] = dict(w=truncated_normal(next(ks), (n_species, d_hidden),
                                             1.0))
    p["rbf_proj"] = _dense(next(ks), n_radial, d_hidden, bias=False)
    p["msg_init"] = _dense(next(ks), 3 * d_hidden, d_hidden)
    for _ in range(n_blocks):
        p["blocks"].append(dict(
            sbf_dn=_dense(next(ks), n_sbf, n_bilinear, bias=False),
            msg_dn=_dense(next(ks), d_hidden, n_bilinear),
            up=_dense(next(ks), n_bilinear, d_hidden),
            rbf_gate=_dense(next(ks), n_radial, d_hidden, bias=False),
            mlp1=_dense(next(ks), d_hidden, d_hidden),
            mlp2=_dense(next(ks), d_hidden, d_hidden),
        ))
    p["out_rbf"] = _dense(next(ks), n_radial, d_hidden, bias=False)
    p["out1"] = _dense(next(ks), d_hidden, d_hidden)
    p["out2"] = _dense(next(ks), d_hidden, d_out)
    return p


def forward(cfg: Cfg, p, g: GraphBatch, triplets):
    """triplets: (t_in, t_out, t_valid) edge-index pairs (k→j, j→i).
    → (node_out [N, d_out], graph_out [n_graphs, d_out])."""
    t_in, t_out, t_valid = triplets
    t_in, t_out = t_in.long(), t_out.long()
    vec, d, unit = edge_vectors(g)
    rbf = bessel_rbf(d, cfg.n_radial, cfg.cutoff)

    if g.node_feat is not None:
        h = _apply(p["embed"], g.node_feat)
    else:
        h = p["embed"]["w"][g.species.long()]

    # initial directional messages m_ji
    e_rbf = _apply(p["rbf_proj"], rbf)
    m = _apply(p["msg_init"],
               torch.cat([h[g.edge_src.long()], h[g.edge_dst.long()], e_rbf],
                         -1))
    m = F.silu(m)

    # angle between edges (k→j) and (j→i): cos θ = −û_kj · û_ji
    cos_t = -(unit[t_in] * unit[t_out]).sum(-1)
    cos_t = torch.clamp(cos_t, -1.0, 1.0)
    sbf = spherical_basis(d[t_in], cos_t, cfg.cutoff,
                          cfg.n_spherical, cfg.n_radial)

    E = m.shape[0]
    for blk in p["blocks"]:
        a = _apply(blk["sbf_dn"], sbf)                        # [T, nb]
        mi = _apply(blk["msg_dn"], m)[t_in]
        tri = _apply(blk["up"], a * mi)                       # [T, d]
        agg = segment_mp(tri * t_valid[:, None], t_out, E)
        upd = agg * _apply(blk["rbf_gate"], rbf)
        mm = F.silu(_apply(blk["mlp1"], m + upd))
        m = m + F.silu(_apply(blk["mlp2"], mm))

    # per-node output: gate messages by rbf, aggregate to destinations
    node = segment_mp(m * _apply(p["out_rbf"], rbf), g.edge_dst,
                      h.shape[0], g.edge_valid)
    node = _apply(p["out2"], F.silu(_apply(p["out1"], node)))
    node = node * g.node_valid[:, None]
    graph = segment_sum(node, g.graph_id, g.n_graphs)
    return node, graph


class DimeNet(ParamTree):
    """DimeNet as a module: ``forward(g, triplets)`` → ``(node_out,
    graph_out)``. ``params`` is a tree from :func:`init_params` (or
    carried from the JAX package, :func:`repro_torch.interop.
    gnn_params_from_jax`); without one, the weights are drawn from the
    threefry ``key`` (default ``threefry.prng_key(0)``). They are placed on
    ``device`` (``None`` = the card)."""

    def __init__(self, cfg: Cfg, params: dict | None = None, *, key=None,
                 device=None):
        super().__init__(init_params(threefry.prng_key(0) if key is None
                                     else key, cfg)
                         if params is None else params)
        self.cfg = cfg
        self.to(resolve_device(device))

    def forward(self, g: GraphBatch, triplets):
        return forward(self.cfg, self.tree(), g, triplets)
