"""Small shared utilities of the PyTorch port (counterpart of ``repro.common``)."""
from __future__ import annotations

from typing import Callable, List, Optional, Union

import torch
import torch.nn.functional as F

#: Activation table shared by the espec layer and the fused-FFN kernels.
#: ``gelu`` is the tanh approximation, as ``jax.nn.gelu`` defaults to.
ACTIVATIONS: dict = {
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "silu": F.silu,
    "relu": F.relu,
    "tanh": torch.tanh,
}

#: Activation ids of the CUDA kernels (``csrc/esffn.cu``'s ``act`` argument).
ACT_IDS = {"silu": 0, "gelu": 1, "relu": 2, "tanh": 3}

#: What quantized expert weights (``w_scales``/``scales``) raise with.
QUANT_NOT_PORTED = ("quantized expert weights (w_scales) are not ported yet "
                    "(ROADMAP.md: quantization slice)")


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(a: int, b: int) -> int:
    return cdiv(a, b) * b


def resolve_device(device: Union[None, str, torch.device] = None) -> torch.device:
    """The device an entry point runs on: the GPU unless the caller names
    another. Asking for (or defaulting to) CUDA where none is present
    raises; nothing falls back to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (CLI: --device "
            "cpu) to run on the CPU")
    return dev


def torch_dtype(name: Optional[str]) -> torch.dtype:
    """``ModelConfig.dtype`` string -> torch dtype."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def tree_leaves(tree) -> List:
    """The leaves of a tree of dicts and lists, in a fixed order: dict keys
    sorted (as ``jax.tree`` orders them), lists in order. ``None`` is a
    leaf."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, list):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure), keeping the structure; leaves
    are visited in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)
