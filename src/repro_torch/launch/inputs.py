"""Placement of the model's inputs on a mesh (counterpart of
``repro.launch.inputs``, the part the LM's mesh steps need).

``activation_spec`` places the (B, S, D) activations at (dp, sp, None),
as the JAX package does; ``batch_block`` cuts this rank's rows of a
global host batch. On a mesh the LM steps take each rank's block of the
batch dimension with the whole sequence: the embedding scatters the
sequence over "sp" itself, and the loss gathers it back.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.parallel.sharding import (
    ParallelConfig,
    as_axes,
    divisible_spec,
    resolve_spec,
)


def activation_spec(shape3, pcfg: ParallelConfig, mesh) -> tuple:
    """The physical spec of (B, S, D) activations of global ``shape3``:
    (dp, sp, None), each axis kept only where it divides its dimension;
    (None, None, None) without a mesh."""
    if mesh is None:
        return (None, None, None)
    return divisible_spec(shape3, resolve_spec((("dp",), "sp", None), pcfg,
                                               mesh), mesh)


def batch_block(batch: dict, x_spec, mesh, *, batch_size: Optional[int]
                = None) -> dict:
    """This rank's rows of a global host batch (numpy arrays or tensors,
    the batch dimension first): the block ``x_spec[0]`` places on it.
    ``batch_size``: the global batch, to check the leaves against."""
    if mesh is None:
        return dict(batch)
    axes = as_axes(x_spec[0])
    n, i = mesh.size(axes), mesh.index(axes)
    out = {}
    for k, v in batch.items():
        b = v.shape[0]
        if batch_size is not None and b != batch_size:
            raise ValueError(f"batch leaf {k!r} has {b} rows, not "
                             f"{batch_size}")
        if b % n:
            raise ValueError(f"batch leaf {k!r}: {b} rows do not split "
                             f"over {n} ranks")
        rows = b // n
        blk = v[i * rows:(i + 1) * rows]
        out[k] = np.ascontiguousarray(blk) if isinstance(v, np.ndarray) \
            else blk.contiguous()
    return out
