"""Small shared utilities of the PyTorch port (counterpart of ``repro.common``)."""
from __future__ import annotations

from typing import Optional, Union

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
