"""AdamW with configurable state dtypes and a warmup-cosine schedule
(counterpart of ``repro.optim.adamw``).

* ``state_dtype`` — dtype of the m/v moments; the update math is f32.
* ``master_fp32`` — keep an f32 master copy of every non-f32 floating
  parameter (mixed-precision training).

Trees are the port's parameter trees (dicts and per-layer lists); leaves
pair up in ``common.tree_leaves`` order. Unlike the JAX version, which
returns new trees, ``apply_updates`` writes the parameters, moments and
masters IN PLACE: at qwen3-moe-30b-a3b's full width the state is 16 bytes
a parameter, and a second copy of it would not fit beside the first on
one card. The step count and the schedule stay on the device, so an
update never waits on the host.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional

import torch

from repro_torch.common import torch_dtype, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    min_lr: float = 3e-5
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_dtype: str = "float32"     # moments dtype
    master_fp32: bool = True         # keep f32 master for low-prec params


def schedule(step: torch.Tensor, cfg: OptimizerConfig) -> torch.Tensor:
    """Learning rate at ``step`` (a 0-d tensor), in f32: linear warmup,
    then cosine decay to ``min_lr`` at ``decay_steps``."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = cfg.peak_lr * step / max(cfg.warmup_steps, 1)
    prog = torch.clamp(
        (step - cfg.warmup_steps) / max(cfg.decay_steps - cfg.warmup_steps, 1),
        0.0, 1.0)
    cos = cfg.min_lr + 0.5 * (cfg.peak_lr - cfg.min_lr) * (
        1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init_opt_state(params: Any, cfg: OptimizerConfig) -> dict:
    """Zero moments, step 0 (an int32 0-d tensor on the parameters'
    device) and, with ``master_fp32``, an f32 copy of every non-f32
    floating leaf (None for the others)."""
    sd = torch_dtype(cfg.state_dtype)
    leaves = tree_leaves(params)
    device = leaves[0].device
    state = {
        "m": tree_map(lambda p: torch.zeros(p.shape, dtype=sd,
                                            device=p.device), params),
        "v": tree_map(lambda p: torch.zeros(p.shape, dtype=sd,
                                            device=p.device), params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
    }
    if cfg.master_fp32:
        state["master"] = tree_map(
            lambda p: (p.detach().to(torch.float32)
                       if p.is_floating_point() and p.dtype != torch.float32
                       else None), params)
    return state


def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of squares of every leaf, in f32."""
    return torch.sqrt(torch.stack([
        torch.sum(torch.square(g.float())) for g in tree_leaves(tree)]).sum())


@torch.no_grad()
def apply_updates(params: Any, grads: Any, state: dict,
                  cfg: OptimizerConfig, *,
                  grad_norm: Optional[torch.Tensor] = None
                  ) -> tuple[Any, dict, dict]:
    """One AdamW step: global-norm clip, bias-corrected moments, decoupled
    weight decay on leaves with ``ndim >= 2`` only. Updates ``params`` and
    ``state``'s tensors in place and returns (params, state, metrics).
    ``grad_norm``: the norm to clip by, where the grads are this rank's
    shards of a larger tree (``models.swin``'s mesh step); by default the
    norm of ``grads``."""
    step = state["step"] + 1
    lr = schedule(step, cfg)
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    if cfg.grad_clip > 0:
        scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                            max=1.0)
    else:
        scale = torch.ones((), dtype=torch.float32, device=gnorm.device)
    stepf = step.to(torch.float32)
    b1c = 1 - torch.pow(torch.tensor(cfg.b1, device=stepf.device), stepf)
    b2c = 1 - torch.pow(torch.tensor(cfg.b2, device=stepf.device), stepf)
    masters = state.get("master")
    flat_ma = (tree_leaves(masters) if masters is not None
               else [None] * len(tree_leaves(params)))

    for p, g, m, v, ma in zip(tree_leaves(params), tree_leaves(grads),
                              tree_leaves(state["m"]),
                              tree_leaves(state["v"]), flat_ma):
        gf = g.float() * scale
        mf = cfg.b1 * m.float() + (1 - cfg.b1) * gf
        vf = cfg.b2 * v.float() + (1 - cfg.b2) * gf * gf
        update = (mf / b1c) / (torch.sqrt(vf / b2c) + cfg.eps)
        # free f32 temporaries early: 0.8 GB each for a 200 M-element leaf
        del gf
        base = ma if ma is not None else p.float()
        decay = cfg.weight_decay if p.ndim >= 2 else 0.0
        new_base = base - lr * (update + decay * base)
        del update
        p.copy_(new_base)
        m.copy_(mf)
        v.copy_(vf)
        if ma is not None:
            ma.copy_(new_base)
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}
