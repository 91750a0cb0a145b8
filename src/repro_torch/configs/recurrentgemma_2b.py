"""recurrentgemma-2b [hybrid] — RG-LRU + local attention, 1 attn : 2 rec.

[arXiv:2402.19427]: 26L, d_model=2560, 10 heads (GQA kv=1, MQA),
head_dim=256, d_ff=7680 (geglu), vocab=256000, window=2048,
lru_width=2560.  Pattern (rglru, rglru, local) cycled.
"""
from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv_heads=1, head_dim=256,
    d_ff=7680, vocab=256_000, layer_pattern=("rglru", "rglru", "local"),
    window=2048, mlp="geglu", lru_width=2560, tie_embeddings=True,
    source="arXiv:2402.19427",
)
SMOKE = reduced(CONFIG, n_layers=3)
