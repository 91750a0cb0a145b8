"""Model API over all the LM families — what the LM training driver, the
step builders and the decode loop drive.

The counterpart of the JAX package's ``models/api.py``:

  init_model(cfg, generator=, device=)   -> params (``backbone.LM``, or
                                            ``whisper.Whisper`` for audio)
  train_loss(params, cfg, batch, remat=True) -> scalar loss
  init_decode_cache(cfg, batch, seq_len, device) -> cache
  decode_step(params, cfg, token, cache, pos) -> (logits, cache)
  make_train_batch(rng, cfg, batch, seq_len) -> batch (numpy)

Batch layouts by family:
  lm families (dense/moe/ssm/hybrid): {tokens (B,S), labels (B,S)}
  vlm:   {tokens (B,S-P), labels (B,S-P), patches (B,P,D)}  (stub frontend)
  audio: {frames (B,S,D), tokens (B,min(S,448)), labels (B,min(S,448))}
         (stub frontend)
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from . import backbone, whisper

__all__ = ["LM_FAMILIES", "init_model", "train_loss", "init_decode_cache",
           "decode_step", "make_train_batch"]

LM_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def init_model(cfg: ModelConfig, *, generator: torch.Generator | None,
               device):
    """Random weights of ``cfg``'s family from ``generator`` on
    ``device``; on ``meta`` (``generator`` None) the shapes and dtypes
    alone, at no memory cost (the dry run's)."""
    if cfg.family == "audio":
        return whisper.init_params(cfg, generator=generator, device=device)
    return backbone.init_params(cfg, generator=generator, device=device)


def train_loss(params, cfg: ModelConfig, batch: dict, remat: bool = True):
    """The family's loss on ``batch``; ``remat`` checkpoints the layers
    as the reference's does (:func:`.backbone.backbone_apply`,
    :func:`.whisper.encode`)."""
    if cfg.family == "audio":
        return whisper.loss(params, cfg, batch["frames"], batch["tokens"],
                            batch["labels"], remat=remat)
    if cfg.family == "vlm":
        return backbone.lm_loss(params, cfg, batch["tokens"],
                                batch["labels"],
                                prefix_embeds=batch["patches"], remat=remat)
    return backbone.lm_loss(params, cfg, batch["tokens"], batch["labels"],
                            remat=remat)


def init_decode_cache(cfg: ModelConfig, batch: int, seq_len: int, device):
    """The backbone's list of layer caches; for audio, whisper's self-KV
    rings and zero cross K/V of ``enc_len = seq_len`` frames."""
    if cfg.family == "audio":
        return whisper.init_cache(cfg, batch, seq_len, device)
    return backbone.init_cache(cfg, batch, seq_len, device)


def decode_step(params, cfg: ModelConfig, token, cache, pos: int):
    if cfg.family == "audio":
        return whisper.decode_step(params, cfg, token, cache, pos)
    return backbone.decode_step(params, cfg, token, cache, pos)


def make_train_batch(rng: np.random.Generator, cfg: ModelConfig, batch: int,
                     seq_len: int) -> dict:
    """Concrete random batch (smoke tests / examples), drawn as the
    reference draws it: one ``rng`` gives both packages the same
    arrays."""
    if cfg.family == "audio":
        dec = min(seq_len, whisper.DEC_CTX)
        return {
            "frames": rng.standard_normal((batch, seq_len, cfg.d_model)).astype(np.float32),
            "tokens": rng.integers(0, cfg.vocab, (batch, dec)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (batch, dec)).astype(np.int32),
        }
    if cfg.family == "vlm":
        S = seq_len - cfg.n_patches
        return {
            "tokens": rng.integers(0, cfg.vocab, (batch, S)).astype(np.int32),
            "labels": rng.integers(0, cfg.vocab, (batch, S)).astype(np.int32),
            "patches": rng.standard_normal((batch, cfg.n_patches, cfg.d_model)).astype(np.float32),
        }
    return {
        "tokens": rng.integers(0, cfg.vocab, (batch, seq_len)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab, (batch, seq_len)).astype(np.int32),
    }
