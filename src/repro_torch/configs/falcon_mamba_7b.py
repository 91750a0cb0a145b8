"""falcon-mamba-7b [ssm] — pure Mamba-1, attention-free.

[arXiv:2410.05355]: 64L, d_model=4096, d_ff=0 (no MLP; the Mamba block is
the mixer+channel layer), vocab=65024, ssm_state=16, expand=2 (d_inner
8192), conv 4.
"""
from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=65024, layer_pattern=("mamba",),
    ssm_state=16, d_conv=4, expand=2, tie_embeddings=True,
    source="arXiv:2410.05355",
)
SMOKE = reduced(CONFIG, d_ff=0)
