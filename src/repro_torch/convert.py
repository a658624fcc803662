"""Weight carry-over from the JAX package's parameter tree.

The two packages draw their random weights differently (threefry vs the
torch generator), so comparisons carry one tree across instead of
initialising twice. The JAX tree stacks each period position's leaves over
periods (``lax.scan`` layout); the port keeps one dict per layer.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import check_supported


def _to_tensor(a, device) -> torch.Tensor:
    arr = np.array(a)                    # an owned, writable copy
    if arr.dtype.name == "bfloat16":     # ml_dtypes' numpy bfloat16
        return torch.from_numpy(arr.view(np.uint16)).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(arr).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def params_from_jax(tree: dict, cfg: ModelConfig, *, device=None) -> dict:
    """The port's parameters from the value tree of
    ``split_tree(repro.models.lm.init_params(...))[0]`` (leaves as numpy
    arrays, or anything ``np.asarray`` takes), on ``device`` (the GPU
    unless given)."""
    check_supported(cfg)
    device = resolve_device(device)
    period = cfg.period
    layers = []
    for li in range(cfg.num_layers):
        pp, pos = divmod(li, period)
        layers.append(_map(tree["layers"][pos],
                           lambda a, pp=pp: _to_tensor(np.asarray(a)[pp], device)))
    out = {k: _map(v, lambda a: _to_tensor(a, device))
           for k, v in tree.items() if k != "layers"}
    out["layers"] = layers
    return out
