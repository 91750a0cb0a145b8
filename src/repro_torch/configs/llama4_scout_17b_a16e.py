"""llama4-scout-17b-a16e [moe] — MoE 16 experts top-1 + shared expert.

[hf:meta-llama/Llama-4-Scout-17B-16E]: 48L, d_model=5120, 40 heads
(GQA kv=8), head_dim=128, expert d_ff=8192, vocab=202048, MoE every layer.
iRoPE attention: 3 of every 4 layers use chunked local attention
(window 8192), every 4th is global (full) — which is what makes this MoE
arch legal for the long_500k shape (cache bounded on 3/4 of layers).
"""
from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e", family="moe",
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=202_048,
    layer_pattern=("chunked", "chunked", "chunked", "full"),
    window=8192, mlp="moe", n_experts=16, top_k=1, shared_expert=True,
    nope_global=True,
    rope_theta=500_000.0, source="hf:meta-llama/Llama-4-Scout-17B-16E",
)
SMOKE = reduced(CONFIG, n_layers=4)
