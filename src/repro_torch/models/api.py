"""Model API over the LM families — what the LM training driver and
the decode loop drive.

The counterpart of the JAX package's ``models/api.py`` for the LM
families:

  init_model(cfg, generator=, device=)   -> params (``backbone.LM``)
  train_loss(params, cfg, batch)         -> scalar loss
  init_decode_cache(cfg, batch, seq_len, device) -> cache
  decode_step(params, cfg, token, cache, pos) -> (logits, cache)
  make_train_batch(rng, cfg, batch, seq_len) -> {tokens, labels} (numpy)

The dense, MoE, SSM and hybrid families run, and a VLM decodes its text
tokens; the VLM prefix (ROADMAP A14.5) and the audio encoder-decoder
(A14.6) raise here.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from . import backbone

__all__ = ["LM_FAMILIES", "init_model", "train_loss", "init_decode_cache",
           "decode_step", "make_train_batch"]

LM_FAMILIES = ("dense", "moe", "ssm", "hybrid")
_ITEMS = {"vlm": "A14.5", "audio": "A14.6"}


def _lm_only(cfg: ModelConfig):
    if cfg.family not in LM_FAMILIES:
        raise NotImplementedError(
            f"the {cfg.family} family ({cfg.name}) is not ported to "
            f"repro_torch yet (ROADMAP {_ITEMS.get(cfg.family, 'A14')})")


def init_model(cfg: ModelConfig, *, generator: torch.Generator,
               device) -> backbone.LM:
    _lm_only(cfg)
    return backbone.init_params(cfg, generator=generator, device=device)


def train_loss(params: backbone.LM, cfg: ModelConfig, batch: dict):
    _lm_only(cfg)
    return backbone.lm_loss(params, cfg, batch["tokens"], batch["labels"])


def _no_audio(cfg: ModelConfig):
    # decode runs on the backbone for every family but audio, as the
    # reference's; a VLM decodes its text tokens
    if cfg.family == "audio":
        _lm_only(cfg)


def init_decode_cache(cfg: ModelConfig, batch: int, seq_len: int,
                      device) -> list:
    _no_audio(cfg)
    return backbone.init_cache(cfg, batch, seq_len, device)


def decode_step(params: backbone.LM, cfg: ModelConfig, token, cache: list,
                pos: int):
    _no_audio(cfg)
    return backbone.decode_step(params, cfg, token, cache, pos)


def make_train_batch(rng: np.random.Generator, cfg: ModelConfig, batch: int,
                     seq_len: int) -> dict:
    """Concrete random batch (smoke tests / examples)."""
    _lm_only(cfg)
    return {
        "tokens": rng.integers(0, cfg.vocab, (batch, seq_len)).astype(np.int32),
        "labels": rng.integers(0, cfg.vocab, (batch, seq_len)).astype(np.int32),
    }
