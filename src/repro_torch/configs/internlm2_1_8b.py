"""internlm2-1.8b [arXiv:2403.17297; hf]: dense GQA decoder.

The twin of ``repro.configs.internlm2_1_8b``: each of ``LMConfig``'s fields
holds the reference's value."""
from repro_torch.configs.base import LMConfig, LM_SHAPES

CONFIG = LMConfig(
    name="internlm2-1.8b", n_layers=24, d_model=2048, n_heads=16,
    n_kv_heads=8, d_ff=8192, vocab=92544,
)
SMOKE = LMConfig(
    name="internlm2-smoke", n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=256, vocab=512, dtype="float32", param_dtype="float32", attn_chunk=32,
)
SHAPES = LM_SHAPES
KIND = "lm"
