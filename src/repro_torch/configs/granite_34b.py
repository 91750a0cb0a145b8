"""granite-34b [dense] — code model, GPT-BigCode-style MQA.  [arXiv:2405.04324]
88L, d_model=6144, 48H (GQA kv=1, MQA), d_ff=24576 (non-gated gelu MLP,
4*d — the BigCode layout, which is what makes the 34B count work out),
vocab=49152."""
from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="granite-34b", family="dense",
    n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, head_dim=128,
    d_ff=24576, vocab=49152, layer_pattern=("full",), mlp="gelu",
    source="arXiv:2405.04324",
)
SMOKE = reduced(CONFIG)
