"""whisper-large-v3 [audio] — encoder-decoder, conv frontend STUB.

[arXiv:2212.04356]: 32L enc + 32L dec, d_model=1280, 20H (kv=20, MHA),
d_ff=5120, vocab=51866.  The mel-spectrogram + conv feature extractor is a
STUB: input_specs() supplies precomputed frame embeddings consumed by the
transformer encoder; the decoder (the transformer backbone we implement)
cross-attends to them.
"""
from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="whisper-large-v3", family="audio",
    n_layers=32, d_model=1280, n_heads=20, n_kv_heads=20, head_dim=64,
    d_ff=5120, vocab=51866, layer_pattern=("full",), mlp="geglu",
    encoder_layers=32, frontend="audio",
    source="arXiv:2212.04356",
)
SMOKE = reduced(CONFIG)
