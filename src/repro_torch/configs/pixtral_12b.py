"""pixtral-12b [vlm] — Pixtral-ViT frontend (stub) + Mistral-Nemo decoder.

[hf:mistralai/Pixtral-12B-2409]: 40L, d_model=5120, 32 heads (GQA kv=8),
head_dim=128, d_ff=14336, vocab=131072.  The vision encoder + projector are
a STUB per the assignment: input_specs() supplies precomputed patch
embeddings (n_patches per sample) that are early-fused before the decoder.
"""
from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="pixtral-12b", family="vlm",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=14336, vocab=131072, layer_pattern=("full",), mlp="swiglu",
    frontend="vision", n_patches=256, rope_theta=1_000_000.0,
    source="hf:mistralai/Pixtral-12B-2409",
)
SMOKE = reduced(CONFIG)
