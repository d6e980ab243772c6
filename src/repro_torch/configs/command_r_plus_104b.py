"""command-r-plus-104b [hf:CohereForAI/c4ai-command-r-v01]: dense GQA, no-bias family.

The twin of ``repro.configs.command_r_plus_104b``: each of ``LMConfig``'s fields
holds the reference's value."""
from repro_torch.configs.base import LMConfig, LM_SHAPES

CONFIG = LMConfig(
    name="command-r-plus-104b", n_layers=64, d_model=12288, n_heads=96,
    n_kv_heads=8, d_ff=33792, vocab=256000,
)
SMOKE = LMConfig(
    name="command-r-smoke", n_layers=2, d_model=192, n_heads=6, n_kv_heads=2,
    d_ff=512, vocab=1000, dtype="float32", param_dtype="float32", attn_chunk=32,
)
SHAPES = LM_SHAPES
KIND = "lm"
OPTIMIZER = "adafactor"
