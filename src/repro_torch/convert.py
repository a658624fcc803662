"""Weight and optimizer-state carry-over from the JAX package's trees.

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
    return None if tree is None else fn(tree)


def params_from_jax(tree: dict, cfg: ModelConfig, *, device=None) -> dict:
    """The port's parameters from the value tree of
    ``split_tree(repro.models.lm.init_params(...))[0]`` (leaves as numpy
    arrays, or anything ``np.asarray`` takes), on ``device`` (the GPU
    unless given)."""
    check_supported(cfg)
    return _unstack(tree, cfg, resolve_device(device))


def opt_state_from_jax(state: dict, cfg: ModelConfig, *, device=None) -> dict:
    """The port's AdamW state (``optim.adamw.init_opt_state``'s layout)
    from ``repro.optim.adamw``'s: the moments ``m``/``v`` and the f32
    ``master`` copies (None where a parameter is f32) unstacked as
    ``params_from_jax`` unstacks the parameters, and ``step`` as an int32
    0-d tensor, all on ``device`` (the GPU unless given)."""
    check_supported(cfg)
    device = resolve_device(device)
    out = {k: _unstack(state[k], cfg, device)
           for k in ("m", "v", "master") if k in state}
    out["step"] = torch.tensor(int(np.asarray(state["step"])),
                               dtype=torch.int32, device=device)
    return out


def _unstack(tree: dict, cfg: ModelConfig, device) -> dict:
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
