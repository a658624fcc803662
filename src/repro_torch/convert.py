"""Weight and optimizer-state carry-over from the JAX package's trees.

The two packages draw their random weights differently (threefry vs the
torch generator), so comparisons carry one tree across instead of
initialising twice. The JAX LM tree stacks each period position's leaves
over periods (``lax.scan`` layout); the port keeps one dict per layer, in
layer order, whatever each position holds (attention, Mamba, mLSTM or
sLSTM mixers; MoE, dense or no FFN). The
Swin tree (dicts and the ``stages``/``blocks`` lists) has the same
structure and leaf layouts in both packages, so it carries over leaf for
leaf.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.configs.base import ModelConfig
from repro_torch.models.lm import check_supported, check_trainable
from repro_torch.models.swin import SwinConfig


#: ml_dtypes' numpy types, which ``torch.from_numpy`` refuses: carried as
#: an unsigned view of the same width, reinterpreted on the torch side.
_VIEWED = {"bfloat16": (np.uint16, torch.bfloat16),
           "float8_e4m3fn": (np.uint8, torch.float8_e4m3fn)}


def _to_tensor(a, device) -> torch.Tensor:
    arr = np.array(a)                    # an owned, writable copy
    if arr.dtype.name in _VIEWED:
        raw, dtype = _VIEWED[arr.dtype.name]
        return torch.from_numpy(arr.view(raw)).view(dtype).to(device)
    return torch.from_numpy(arr).to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return None if tree is None else fn(tree)


def params_from_jax(tree: dict, cfg: ModelConfig, *, device=None) -> dict:
    """The port's parameters from the value tree of
    ``split_tree(repro.models.lm.init_params(...))[0]`` (leaves as numpy
    arrays, or anything ``np.asarray`` takes), on ``device`` (the GPU
    unless given). A tree from ``repro.quant.quantize_lm_params`` carries
    over with its int8/fp8 payloads and ``<name>_scale`` leaves."""
    check_supported(cfg)
    return _unstack(tree, cfg, resolve_device(device))


def opt_state_from_jax(state: dict, cfg: ModelConfig, *, device=None) -> dict:
    """The port's AdamW state (``optim.adamw.init_opt_state``'s layout)
    from ``repro.optim.adamw``'s: the moments ``m``/``v`` and the f32
    ``master`` copies (None where a parameter is f32) unstacked as
    ``params_from_jax`` unstacks the parameters, and ``step`` as an int32
    0-d tensor, all on ``device`` (the GPU unless given)."""
    check_trainable(cfg)
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


def _check_swin(tree: dict, cfg: SwinConfig) -> None:
    depths = tuple(len(st["blocks"]) for st in tree["stages"])
    if depths != tuple(cfg.depths):
        raise ValueError(f"the tree's stage depths {depths} are not "
                         f"{cfg.name}'s {tuple(cfg.depths)}")


def swin_params_from_jax(tree: dict, cfg: SwinConfig, *, device=None) -> dict:
    """The port's Swin parameters from the value tree of
    ``split_tree(repro.models.swin.init_swin(...))[0]`` (leaves as numpy
    arrays, or anything ``np.asarray`` takes), leaf for leaf in the same
    layouts, on ``device`` (the GPU unless given)."""
    _check_swin(tree, cfg)
    device = resolve_device(device)
    return _map(tree, lambda a: _to_tensor(a, device))


def swin_opt_state_from_jax(state: dict, cfg: SwinConfig, *,
                            device=None) -> dict:
    """The port's AdamW state for Swin from ``repro.optim.adamw``'s: the
    moments ``m``/``v`` (and ``master``, where the state has one: not at
    ``master_fp32=False``) as ``swin_params_from_jax`` carries the
    parameters, and ``step`` as an int32 0-d tensor, on ``device`` (the GPU
    unless given)."""
    device = resolve_device(device)
    out = {}
    for k in ("m", "v", "master"):
        if k in state:
            _check_swin(state[k], cfg)
            out[k] = _map(state[k], lambda a: _to_tensor(a, device))
    out["step"] = torch.tensor(int(np.asarray(state["step"])),
                               dtype=torch.int32, device=device)
    return out


def shard_params(tree, specs, cfg, mesh, *, device=None):
    """This rank's shards of a parameter tree given as numpy arrays (a JAX
    value tree, or anything ``np.asarray`` takes), under the logical
    ``specs`` (a tree of the same structure, e.g. ``models.swin.
    param_specs``) and ``cfg.mode``: the global tree carried over and cut
    as ``parallel.sharding.shard`` cuts it, on ``device`` (the GPU unless
    given)."""
    from repro_torch.parallel.sharding import shard_tree

    device = resolve_device(device)
    return shard_tree(_map(tree, lambda a: _to_tensor(a, device)), specs,
                      cfg, mesh)


def shard_opt_state(state: dict, specs, cfg, mesh, *, device=None) -> dict:
    """This rank's shards of an AdamW state given as numpy arrays (the
    JAX ``repro.optim.adamw`` state, or the port's as numpy): the moments
    ``m``/``v`` (and ``master``, where present) cut as ``shard_params``
    cuts the parameters they follow, and ``step`` as an int32 0-d
    tensor."""
    device = resolve_device(device)
    out = {k: shard_params(state[k], specs, cfg, mesh, device=device)
           for k in ("m", "v", "master") if k in state}
    out["step"] = torch.tensor(int(np.asarray(state["step"])),
                               dtype=torch.int32, device=device)
    return out
