"""Modality frontends (counterpart of ``repro.models.frontends``).

The SigLIP (paligemma-3b) and EnCodec (musicgen-large) encoders are not
part of the model: the caller hands in their precomputed patch or frame
embeddings. What the model owns is the learned projection from the
frontend's embedding width into ``d_model``.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.sharding import normal_init

#: Logical spec of the projection (the JAX package's).
FRONTEND_LOGICAL = {"proj": (None, "fsdp")}


def init_frontend(cfg: ModelConfig, dtype, generator, device) -> dict:
    """``proj`` ``(frontend_dim, d_model)``; empty without a frontend."""
    if cfg.frontend is None:
        return {}
    assert cfg.frontend_dim > 0, cfg.name
    return {"proj": normal_init((cfg.frontend_dim, cfg.d_model), dtype,
                                generator, device)}


def project_frontend(p: dict, feats: torch.Tensor, dtype) -> torch.Tensor:
    """(B, S, frontend_dim) precomputed embeddings -> (B, S, D) in
    ``dtype``."""
    return feats.to(dtype) @ p["proj"].to(dtype)
