"""Config system: model architecture + input-shape descriptors.

Every assigned architecture gets its own ``configs/<id>.py`` defining
``CONFIG`` (exact, full-size) and ``SMOKE`` (reduced: <=2 layers,
d_model<=512, <=4 experts) of the same family.
``repro_torch.configs.get_config`` resolves ids for the launcher's
``--arch`` flag.  The port keeps its own copy of the JAX package's
module, unchanged otherwise, so both resolve every id to equal configs.
"""
from __future__ import annotations

import dataclasses
from typing import Literal, Sequence

__all__ = ["ModelConfig", "ShapeConfig", "INPUT_SHAPES", "reduced"]

LayerKind = Literal["full", "local", "chunked", "mamba", "rglru"]
MlpKind = Literal["swiglu", "geglu", "relu2", "gelu", "moe"]


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: Literal["dense", "moe", "ssm", "hybrid", "vlm", "audio", "dlrm"]
    n_layers: int
    d_model: int
    n_heads: int            # 0 for attention-free archs
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0       # 0 -> d_model // n_heads
    # layer pattern: cycled over layers, e.g. ("rglru","rglru","local")
    layer_pattern: tuple[LayerKind, ...] = ("full",)
    window: int = 0         # local/chunked attention span
    mlp: MlpKind = "swiglu"
    # MoE
    n_experts: int = 0
    top_k: int = 0
    shared_expert: bool = False      # llama4-style always-on expert
    # SSM (mamba1)
    ssm_state: int = 0
    d_conv: int = 4
    expand: int = 2
    # hybrid (RG-LRU)
    lru_width: int = 0      # 0 -> d_model
    # enc-dec (whisper)
    encoder_layers: int = 0
    # modality frontend stub: input_specs() provides these embeddings
    frontend: Literal["none", "vision", "audio"] = "none"
    n_patches: int = 0      # vision tokens prepended per sample (stub)
    nope_global: bool = False   # llama4 iRoPE: "full" layers skip RoPE
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    dtype: str = "bfloat16"
    source: str = ""        # citation

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // max(self.n_heads, 1))

    def kinds(self) -> tuple[LayerKind, ...]:
        p = self.layer_pattern
        return tuple(p[i % len(p)] for i in range(self.n_layers))

    @property
    def sub_quadratic(self) -> bool:
        """True iff the arch has a bounded-context mixing mechanism on (at
        least) most layers — SSM/RG-LRU/local/chunked attention.  llama4's
        iRoPE (3/4 chunked + 1/4 global-NoPE) qualifies: that is its
        long-context design.  Pure full-attention stacks and encoders
        don't."""
        if self.encoder_layers:
            return False
        return any(k in ("local", "chunked", "mamba", "rglru")
                   for k in self.layer_pattern)

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers + head)."""
        d, ff, V = self.d_model, self.d_ff, self.vocab
        hd, H, KV = self.hd, self.n_heads, self.n_kv_heads
        emb = V * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        for kind in self.kinds():
            if kind in ("full", "local", "chunked"):
                per_layer += d * H * hd + 2 * d * KV * hd + H * hd * d
            elif kind == "mamba":
                di = self.expand * d
                per_layer += d * 2 * di + di * self.d_conv + \
                    di * (2 * self.ssm_state + di // 16) + (di // 16) * di + di * d + di
            elif kind == "rglru":
                w = self.lru_width or d
                per_layer += 2 * d * w + w * d + 4 * w  # in/out proj + gates
            if kind != "mamba":
                if self.mlp == "moe":
                    e = self.n_experts * 3 * d * ff
                    if self.shared_expert:
                        e += 3 * d * ff
                    per_layer += e + d * self.n_experts
                elif self.mlp in ("swiglu", "geglu"):
                    per_layer += 3 * d * ff
                else:
                    per_layer += 2 * d * ff
            per_layer += 2 * d  # norms
        enc = 0
        if self.encoder_layers:
            enc = self.encoder_layers * (4 * d * H * hd + 2 * d * ff + 2 * d)
            enc += self.encoder_layers * (2 * d * KV * hd)
        return emb + per_layer + enc

    def active_param_count(self) -> int:
        """Params touched per token (MoE: top_k + shared of n_experts)."""
        if self.mlp != "moe":
            return self.param_count()
        d, ff = self.d_model, self.d_ff
        dense_like = dataclasses.replace(self, mlp="swiglu")
        base = dense_like.param_count() - len(self.kinds()) * 3 * d * ff
        active = (self.top_k + (1 if self.shared_expert else 0)) * 3 * d * ff
        return base + len(self.kinds()) * active + len(self.kinds()) * d * self.n_experts


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: Literal["train", "prefill", "decode"]
    seq_len: int
    global_batch: int


INPUT_SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """Reduced same-family variant for CPU smoke tests."""
    pat_len = len(cfg.layer_pattern)
    small = dict(
        name=cfg.name + "-smoke",
        n_layers=min(cfg.n_layers, max(2, pat_len)),
        d_model=min(cfg.d_model, 256),
        n_heads=min(cfg.n_heads, 4) if cfg.n_heads else 0,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads else 0,
        d_ff=min(cfg.d_ff, 512),
        vocab=min(cfg.vocab, 1024),
        head_dim=64 if cfg.n_heads else 0,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        window=min(cfg.window, 64) if cfg.window else 0,
        encoder_layers=min(cfg.encoder_layers, 2),
        n_patches=min(cfg.n_patches, 16),
        lru_width=min(cfg.lru_width, 256) if cfg.lru_width else 0,
        dtype="float32",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
