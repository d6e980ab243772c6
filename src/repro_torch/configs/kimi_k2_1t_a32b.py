"""kimi-k2-1t-a32b [arXiv:2501.kimi2 paper-table]: 1T MoE, 384e top-8.

The twin of ``repro.configs.kimi_k2_1t_a32b``: each of ``LMConfig``'s fields
holds the reference's value."""
from repro_torch.configs.base import LMConfig, LM_SHAPES, MoESpec

CONFIG = LMConfig(
    name="kimi-k2-1t-a32b", n_layers=61, d_model=7168, n_heads=64,
    n_kv_heads=8, d_ff=0, vocab=163840,
    moe=MoESpec(n_experts=384, top_k=8, d_ff_expert=2048, group_size=256,
                group_chunks=16),
)
SMOKE = LMConfig(
    name="kimi-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=0, vocab=512, dtype="float32", param_dtype="float32", attn_chunk=32,
    moe=MoESpec(n_experts=12, top_k=4, d_ff_expert=64, group_size=32),
)
SHAPES = LM_SHAPES
KIND = "lm"
OPTIMIZER = "adafactor"
