"""Public expert-specific ops: forward dispatch of the fused expert FFN
(counterpart of ``repro.kernels.ops``).

The implementation follows the tensor's device: ``"cuda"`` (the
hand-written kernel) for a CUDA tensor, ``"torch"`` (its plain version)
for a CPU tensor. Autodiff, the unfused ESMM/ESFK path and the MLP expert
body belong to later slices (ROADMAP.md).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import esffn as esffn_kernel


def esffn_glu(x, row_token, row_gate, block_expert, padded_counts, w_gate,
              w_up, w_down, *, scales=None, act: str = "silu") -> torch.Tensor:
    """Fused GLU expert FFN over the sorted layout (forward only).

    x: (N, D) UNSORTED tokens; row maps from ``core.reindex.build_reindex``.
    Returns the gate-weighted sorted output (Np, D) — combine it with
    ``core.reindex.scatter_rows``. ``padded_counts`` is the JAX op's
    group-extent argument; the fused forward reads only the block map."""
    del padded_counts
    return esffn_kernel.esffn_glu(x, row_token, row_gate, block_expert,
                                  w_gate, w_up, w_down, w_scales=scales,
                                  act=act)
