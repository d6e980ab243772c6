"""llama4-maverick-400b-a17b [hf:meta-llama/Llama-4-*]: MoE 128e top-1.

The twin of ``repro.configs.llama4_maverick_400b_a17b``: each of ``LMConfig``'s fields
holds the reference's value."""
from repro_torch.configs.base import LMConfig, LM_SHAPES, MoESpec

CONFIG = LMConfig(
    name="llama4-maverick-400b-a17b", n_layers=48, d_model=5120, n_heads=40,
    n_kv_heads=8, d_ff=0, vocab=202048,
    moe=MoESpec(n_experts=128, top_k=1, d_ff_expert=8192, group_size=256,
                group_chunks=16),
)
SMOKE = LMConfig(
    name="llama4-smoke", n_layers=2, d_model=160, n_heads=5, n_kv_heads=1,
    d_ff=0, vocab=512, dtype="float32", param_dtype="float32", attn_chunk=32,
    moe=MoESpec(n_experts=8, top_k=1, d_ff_expert=128, group_size=32),
)
SHAPES = LM_SHAPES
KIND = "lm"
OPTIMIZER = "adafactor"
