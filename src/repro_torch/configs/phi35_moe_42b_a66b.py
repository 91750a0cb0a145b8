"""phi3.5-moe-42b-a6.6b [moe] — 16 experts, top-2 routing.

[hf:microsoft/Phi-3.5-MoE-instruct]: 32L, d_model=4096, 32 heads
(GQA kv=8), head_dim=128, expert d_ff=6400, vocab=32064, MoE 16e top-2.
"""
from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=6400, vocab=32064, layer_pattern=("full",),
    mlp="moe", n_experts=16, top_k=2,
    source="hf:microsoft/Phi-3.5-MoE-instruct",
)
SMOKE = reduced(CONFIG)
