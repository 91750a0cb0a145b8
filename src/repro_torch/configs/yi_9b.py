"""yi-9b [dense] — llama-arch GQA.  [arXiv:2403.04652]
48L, d_model=4096, 32H (GQA kv=4), d_ff=11008, vocab=64000."""
from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="yi-9b", family="dense",
    n_layers=48, d_model=4096, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=11008, vocab=64000, layer_pattern=("full",),
    source="arXiv:2403.04652",
)
SMOKE = reduced(CONFIG)
