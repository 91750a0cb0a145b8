"""smollm-360m [dense] — llama-arch small.  [hf:HuggingFaceTB/SmolLM-135M]
32L, d_model=960, 15H (GQA kv=5), head_dim=64, d_ff=2560, vocab=49152."""
from .base import ModelConfig, reduced

CONFIG = ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5, head_dim=64,
    d_ff=2560, vocab=49152, layer_pattern=("full",), tie_embeddings=True,
    source="hf:HuggingFaceTB/SmolLM-135M",
)
SMOKE = reduced(CONFIG)
