"""minitron-4b [dense] — pruned Nemotron.  [arXiv:2407.14679]
32L, d_model=3072, 24H (GQA kv=8), head_dim=128, d_ff=9216 (squared-ReLU
MLP, non-gated, per nemotron), vocab=256000."""
from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="minitron-4b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv_heads=8, head_dim=128,
    d_ff=9216, vocab=256_000, layer_pattern=("full",), mlp="relu2",
    source="arXiv:2407.14679",
)
SMOKE = reduced(CONFIG)
