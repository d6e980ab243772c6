"""TriPoll — the paper's own workload, dry-runnable at production scale.

rmat32-class synthetic web graph: ~1 B vertices, ~34 B oriented edges
(cf. paper Sec 5.5 weak scaling up to scale-32 R-MAT), closure-time
survey with one float edge-metadata column (Reddit experiment, Sec 5.7).
Capacities are per-shard plan constants (ceil splits over 256 shards).
The reference's ``CONFIG``, ``SMOKE``, ``SHAPES`` and ``KIND``, field for
field.
"""
from repro_torch.configs.base import ShapeCell, TriPollConfig

CONFIG = TriPollConfig(
    name="tripoll-rmat32", n_global=1 << 30, n_loc=(1 << 30) // 256,
    e_cap=134_217_728, d_plus_max=2048, dei=0, def_=1,
    mode="pushpull", push_cap=3072, n_push_steps=86,
    pull_q_cap=2, pull_edge_cap=8, n_pull_steps=1024,
)
SMOKE = TriPollConfig(
    name="tripoll-smoke", n_global=512, n_loc=128, e_cap=2048, d_plus_max=64,
    dei=0, def_=1, mode="pushpull", push_cap=128, n_push_steps=8,
    pull_q_cap=8, pull_edge_cap=32, n_pull_steps=4,
)
SHAPES = (
    ShapeCell("survey_pushpull", "graph", extras=dict(mode="pushpull")),
    ShapeCell("survey_push", "graph", extras=dict(mode="push")),
    # multi-survey polling: 4 surveys folded in one pushpull traversal —
    # same exchange volume as survey_pushpull, ~4× the survey answers
    ShapeCell("survey_bundle", "graph", extras=dict(mode="pushpull", bundle=True)),
)
KIND = "tripoll"
