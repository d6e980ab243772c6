"""Paper §1 motivation made concrete: metadata-triangle incidence as
feature vectors for downstream ML.

TriPoll computes per-vertex triangle participation counts
(LocalVertexCount survey); a SchNet-style GNN then classifies vertices
into high/low clustering classes. The triangle feature lifts accuracy
well above the featureless baseline — the "downwind application" loop
the paper describes, end to end in one script.

    PYTHONPATH=src python -m repro_torch.examples.triangle_features_gnn [--device cpu]

The model starts from the JAX twin's weights (``threefry.prng_key(0)``
draws what ``jax.random.PRNGKey(0)`` draws) and trains with the port's
AdamW, so its first steps follow the twin's losses; the training is
chaotic later (see :mod:`repro_torch.examples.expected`). :func:`run`
takes any graph (and its shards, or its counts from another survey) and
any SchNet widths: ``chip_smoke.py`` runs it on its full-size deployment
at SchNet's published widths.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.core.dodgr import shard_dodgr
from repro_torch.core.engine import survey_push_pull
from repro_torch.core.pushpull import plan_engine
from repro_torch.core.surveys import LocalVertexCount
from repro_torch.examples import cli
from repro_torch.graphs import generators
from repro_torch.models import threefry
from repro_torch.models.gnn import common, schnet
from repro_torch.train import adamw, make_train_step
from repro_torch.train.optimizer import tree_map
from repro_torch.train.trainer import init_state
from repro_torch.utils import resolve_device, sync

# the twin's model: two interactions, 32 wide, 8 radial bases
EXAMPLE_CFG = schnet.Cfg(n_interactions=2, d_hidden=32, n_rbf=8, cutoff=2.0)
LABELS = ("baseline (degree only)      ", "with TriPoll triangle feature")


def model_cfg(cfg, d_feat: int) -> schnet.Cfg:
    """The SchNet widths of ``cfg`` (a ``schnet.Cfg``, a ``GNNConfig`` such
    as ``configs.schnet.CONFIG``, or ``None`` for the twin's) with the
    example's inputs and two classes."""
    if cfg is None:
        cfg = EXAMPLE_CFG
    if isinstance(cfg, GNNConfig):
        cfg = schnet.Cfg(n_interactions=cfg.n_layers, d_hidden=cfg.d_hidden,
                         n_rbf=cfg.extras["n_rbf"], cutoff=cfg.extras["cutoff"])
    return dataclasses.replace(cfg, d_feat=d_feat, d_out=2)


def survey_counts(g, S: int, dev, gr=None, push_cap: int = 512,
                  pull_q_cap: int = 16):
    """Per-vertex triangle counts by a push-pull LocalVertexCount survey
    (shards built here unless ``gr`` is given); returns the counts and the
    survey's wall seconds."""
    if gr is None:
        gr, _ = shard_dodgr(g, S=S, device=dev)
    cfg, _ = plan_engine(g, S, LocalVertexCount(g.n), mode="pushpull",
                         push_cap=push_cap, pull_q_cap=pull_q_cap)
    sync(dev)
    t0 = time.perf_counter()
    counts, st = survey_push_pull(gr, LocalVertexCount(g.n), cfg)
    sync(dev)
    return counts, time.perf_counter() - t0, st


def features(g, counts):
    """The degree features, the same with the triangle feature, and the
    labels, from the per-vertex triangle ``counts`` (float32)."""
    # task: predict whether a vertex's local CLUSTERING COEFFICIENT
    # (triangles / possible wedges) is above median — decorrelated from raw
    # degree, so the triangle feature carries real signal
    deg = g.degrees().astype(np.float32)
    poss = np.maximum(deg * (deg - 1) / 2, 1.0)
    cc = counts / poss
    labels = (cc > np.median(cc[deg >= 2])).astype(np.int32)
    feat_base = np.stack([np.log1p(deg), np.ones_like(deg)], 1)
    feat_tri = np.concatenate(
        [feat_base, np.log1p(counts)[:, None]], 1)  # + TriPoll feature
    return feat_base, feat_tri, labels


def make_graph(g, feats, dev) -> common.GraphBatch:
    n = g.n
    e_src = np.concatenate([g.src, g.dst]).astype(np.int32)
    e_dst = np.concatenate([g.dst, g.src]).astype(np.int32)
    t = lambda a: torch.as_tensor(a, device=dev)
    return common.GraphBatch(
        node_feat=t(np.ascontiguousarray(feats, np.float32)), species=None,
        positions=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        edge_src=t(e_src), edge_dst=t(e_dst),
        edge_valid=torch.ones(len(e_src), dtype=torch.bool, device=dev),
        node_valid=torch.ones(n, dtype=torch.bool, device=dev),
        graph_id=torch.zeros(n, dtype=torch.int32, device=dev), n_graphs=1)


def make_loss(mc: schnet.Cfg, y):
    """The example's loss: mean cross-entropy of the node logits."""
    def loss_fn(p, b):
        node, _ = schnet.forward(mc, p, b)
        lz = torch.logsumexp(node, -1)
        gold = torch.take_along_dim(node, y[:, None].long(), -1)[:, 0]
        return (lz - gold).mean(), {}
    return loss_fn


def init_weights(mc: schnet.Cfg, dev) -> dict:
    """The twin's initial weights (``PRNGKey(0)``) on ``dev``."""
    return tree_map(lambda t: t.to(dev),
                    schnet.init_params(threefry.prng_key(0), mc))


def train_eval(mc: schnet.Cfg, batch, y, name: str, steps: int, dev) -> dict:
    params = init_weights(mc, dev)
    loss_fn = make_loss(mc, y)
    opt = adamw(5e-3)
    state = init_state(params, opt)
    step = make_train_step(loss_fn, opt)
    walls = []
    losses = []
    for _ in range(steps):
        sync(dev)
        t0 = time.perf_counter()
        state, m = step(state, batch)
        sync(dev)
        walls.append(time.perf_counter() - t0)
        losses.append(m["loss"])
    with torch.no_grad():
        node, _ = schnet.forward(mc, state.params, batch)
        acc = float((torch.argmax(node, -1) == y).float().mean())
    loss = float(m["loss"])
    print(f"{name}: loss {loss:.4f}, accuracy {acc:.3f}")
    return dict(loss=loss, accuracy=acc, losses=[float(x) for x in losses],
                step_s=walls)


def run(g, *, S: int = 4, cfg=None, steps: int = 60, device=None, gr=None,
        push_cap: int = 512, pull_q_cap: int = 16) -> dict:
    """The example's loop on ``g`` (over the shards ``gr`` if given): the
    survey, the features and labels, and both trainings. Returns every
    printed number, the counts, the survey's wall and stats, and each
    training step's loss and wall."""
    dev = resolve_device(device)
    n = g.n

    # --- TriPoll pass: per-vertex triangle counts ---
    out = {}
    counts, out["survey_s"], out["survey_stats"] = survey_counts(
        g, S, dev, gr, push_cap, pull_q_cap)
    out["counts"] = np.asarray(counts)
    counts = np.asarray(counts, np.float32)
    print(f"triangle participation: max {counts.max():.0f}, "
          f"mean {counts.mean():.2f}")
    out.update(max_count=float(counts.max()), mean_count=float(counts.mean()))

    feat_base, feat_tri, labels = features(g, counts)

    y = torch.as_tensor(labels, device=dev)
    runs = []
    for feats, name in zip((feat_base, feat_tri), LABELS):
        mc = model_cfg(cfg, feats.shape[1])
        batch = make_graph(g, feats, dev)
        runs.append(train_eval(mc, batch, y, name, steps, dev))
        del batch
    out["base"], out["tri"] = runs
    gain = (runs[1]["accuracy"] - runs[0]["accuracy"]) * 100
    print(f"\ntriangle-feature gain: +{gain:.1f} points")
    out["gain"] = gain
    out["vertices"] = n
    return out


def main(device=None, scale=None, cfg=None) -> dict:
    """The twin's run (``scale=None``: an R-MAT of scale 8, edge factor
    12, seed 21; SchNet widths ``cfg``, default the twin's)."""
    g = generators.rmat(8 if scale is None else scale, 12, seed=21)
    return run(g, S=4, cfg=cfg, device=device)


if __name__ == "__main__":
    cli(main, __doc__)
