"""phi3-mini-3.8b [arXiv:2404.14219]: RoPE SwiGLU, MHA (kv=32), d_head=96.

The twin of ``repro.configs.phi3_mini_3_8b``: each of ``LMConfig``'s fields
holds the reference's value."""
from repro_torch.configs.base import LMConfig, LM_SHAPES

CONFIG = LMConfig(
    name="phi3-mini-3.8b", n_layers=32, d_model=3072, n_heads=32,
    n_kv_heads=32, d_ff=8192, vocab=32064,
)
SMOKE = LMConfig(
    name="phi3-smoke", n_layers=2, d_model=96, n_heads=4, n_kv_heads=4,
    d_ff=256, vocab=512, dtype="float32", param_dtype="float32", attn_chunk=32,
)
SHAPES = LM_SHAPES
KIND = "lm"
