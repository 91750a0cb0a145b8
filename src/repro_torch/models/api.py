"""Model API over the LM families — what the LM training driver drives.

The counterpart of the JAX package's ``models/api.py`` for the dense
families:

  init_model(cfg, generator=, device=)   -> params (``backbone.LM``)
  train_loss(params, cfg, batch)         -> scalar loss
  make_train_batch(rng, cfg, batch, seq_len) -> {tokens, labels} (numpy)

The VLM prefix, the audio encoder-decoder and decode are ROADMAP A14.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from . import backbone

__all__ = ["LM_FAMILIES", "init_model", "train_loss", "make_train_batch"]

LM_FAMILIES = ("dense", "moe", "ssm", "hybrid")


def _lm_only(cfg: ModelConfig):
    if cfg.family not in LM_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family} family ({cfg.name}) is not ported to "
            f"repro_torch yet (ROADMAP A14)")


def init_model(cfg: ModelConfig, *, generator: torch.Generator,
               device) -> backbone.LM:
    _lm_only(cfg)
    return backbone.init_params(cfg, generator=generator, device=device)


def train_loss(params: backbone.LM, cfg: ModelConfig, batch: dict):
    _lm_only(cfg)
    return backbone.lm_loss(params, cfg, batch["tokens"], batch["labels"])


def make_train_batch(rng: np.random.Generator, cfg: ModelConfig, batch: int,
                     seq_len: int) -> dict:
    """Concrete random batch (smoke tests / examples)."""
    _lm_only(cfg)
    return {
        "tokens": rng.integers(0, cfg.vocab, (batch, seq_len)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab, (batch, seq_len)).astype(np.int32),
    }
