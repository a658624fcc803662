"""AdamW as ``optim/adamw.py`` states it, copied (not imported): global-norm
clip, bias-corrected moments, decoupled weight decay on leaves of two or
more dimensions, linear warm-up then cosine decay of the learning rate.
All in f32."""
from __future__ import annotations

import math

import torch


def learning_rate(step: int, cfg: dict) -> float:
    if step < cfg["warmup_steps"]:
        return cfg["peak_lr"] * step / max(cfg["warmup_steps"], 1)
    prog = min(max((step - cfg["warmup_steps"])
                   / max(cfg["decay_steps"] - cfg["warmup_steps"], 1), 0.0),
               1.0)
    return cfg["min_lr"] + 0.5 * (cfg["peak_lr"] - cfg["min_lr"]) * (
        1 + math.cos(math.pi * prog))


@torch.no_grad()
def step(params: list, grads: list, state: dict, cfg: dict) -> list:
    """One update of the ``params`` tensors in place; returns the clipped
    gradients the moments took."""
    state["step"] = state.get("step", 0) + 1
    t = state["step"]
    if "m" not in state:
        state["m"] = [torch.zeros_like(p) for p in params]
        state["v"] = [torch.zeros_like(p) for p in params]
    lr = learning_rate(t, cfg)
    gnorm = torch.sqrt(sum(torch.sum(g.double() ** 2) for g in grads))
    scale = (min(cfg["grad_clip"] / max(float(gnorm), 1e-9), 1.0)
             if cfg["grad_clip"] > 0 else 1.0)
    b1c, b2c = 1 - cfg["b1"] ** t, 1 - cfg["b2"] ** t
    clipped = []
    for p, g, m, v in zip(params, grads, state["m"], state["v"]):
        g = g * scale
        clipped.append(g)
        m.mul_(cfg["b1"]).add_(g, alpha=1 - cfg["b1"])
        v.mul_(cfg["b2"]).add_(g * g, alpha=1 - cfg["b2"])
        update = (m / b1c) / (torch.sqrt(v / b2c) + cfg["eps"])
        decay = cfg["weight_decay"] if p.ndim >= 2 else 0.0
        p.sub_(lr * (update + decay * p))
    return clipped
