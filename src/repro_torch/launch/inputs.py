"""The model's inputs and their placement on a mesh (counterpart of
``repro.launch.inputs``).

``activation_spec`` places the (B, S, D) activations at (dp, sp, None),
as the JAX package does; ``batch_block`` cuts this rank's rows of a
global host batch. On a mesh the LM steps take each rank's block of the
batch dimension with the whole sequence: the embedding scatters the
sequence over "sp" itself, and the loss gathers it back.

``input_specs`` and ``cache_specs`` describe one (arch x shape) cell's
inputs and dense decode cache without allocating them: a ``TensorSpec``
(global shape, dtype, and on a mesh the port's physical placement) a
leaf, the JAX package's shapes and dtypes exactly. The placement is the
port's: the batch over the data axes as JAX places it, the token
sequence whole (the JAX package splits it over "sp"), the cache's K/V
heads over "tp" where they split (JAX splits the cache's sequence) and
its layers a list (JAX stacks them by period). ``TensorSpec.meta`` gives
the rank's block as a meta tensor (``launch.dryrun``);
``concrete_inputs`` draws real (small) inputs from a seed, the numbers
the JAX package's draws.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from repro_torch.common import resolve_device, tree_map
from repro_torch.configs.base import ModelConfig, ShapeConfig

from repro_torch.parallel.sharding import (
    ParallelConfig,
    as_axes,
    divisible_spec,
    resolve_spec,
)


class TensorSpec(NamedTuple):
    """A tensor that is not allocated: its global shape and dtype, and its
    physical spec on a mesh (None without one)."""
    shape: tuple
    dtype: torch.dtype
    spec: Optional[tuple] = None

    def local_shape(self, mesh) -> tuple:
        """The shape of one rank's block."""
        if mesh is None or self.spec is None:
            return tuple(self.shape)
        return tuple(n // mesh.size(a) for n, a in zip(
            self.shape, tuple(self.spec) + (None,) * len(self.shape)))

    def meta(self, mesh=None) -> torch.Tensor:
        """One rank's block as a meta tensor (no memory)."""
        return torch.empty(self.local_shape(mesh), dtype=self.dtype,
                           device="meta")


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


def _placed(shape, dtype, logical, pcfg: ParallelConfig, mesh) -> TensorSpec:
    if mesh is None:
        return TensorSpec(tuple(shape), dtype)
    return TensorSpec(tuple(shape), dtype, divisible_spec(
        shape, resolve_spec(logical, pcfg, mesh), mesh))


def input_specs(cfg: ModelConfig, shape: ShapeConfig, pcfg: ParallelConfig,
                mesh) -> dict:
    """The model inputs of one (arch x shape) cell, as ``TensorSpec``s in
    the JAX package's order, shapes and dtypes: tokens (a decode cell's
    one token a slot; a siglip train or prefill cell's tokens after its
    ``prefix_len`` patches), encodec embeds and 64 conditioning rows, and
    a train cell's labels and loss mask. On a mesh the batch is placed
    over "dp" and the rest is whole."""
    b, s = shape.global_batch, shape.seq_len
    s_in = 1 if shape.kind == "decode" else s
    i32, f32 = torch.int32, torch.float32

    def put(shp, dtype):
        return _placed(shp, dtype, (("dp",),), pcfg, mesh)

    out = {}
    if cfg.frontend == "siglip" and shape.kind != "decode":
        out["patches"] = put((b, cfg.prefix_len, cfg.frontend_dim), f32)
        out["tokens"] = put((b, s_in - cfg.prefix_len), i32)
    elif cfg.frontend == "encodec":
        out["embeds"] = put((b, s_in, cfg.frontend_dim), f32)
        out["cond"] = put((b, 64, cfg.cross_d), f32)
    else:
        out["tokens"] = put((b, s_in), i32)
    if shape.kind == "train":
        # the labels cover the whole forward, image prefix included, as
        # the JAX package's spec has them
        out["labels"] = put((b, s, cfg.num_codebooks) if cfg.num_codebooks
                            > 1 else (b, s), i32)
        out["loss_mask"] = put((b, s), f32)
    return out


def cache_specs(cfg: ModelConfig, shape: ShapeConfig, pcfg: ParallelConfig,
                mesh) -> dict:
    """The dense decode cache of one cell as ``TensorSpec``s, in
    ``models.lm.cache_spec``'s tree (a list of layers), placed by
    ``models.lm.cache_specs`` on a mesh."""
    from repro_torch.models import lm

    tree = lm.cache_spec(cfg, shape.global_batch, shape.seq_len)
    if mesh is None:
        return tree_map(lambda sd: TensorSpec(tuple(sd[0]), sd[1]), tree)
    specs = lm.cache_specs(cfg, pcfg, mesh, shape.global_batch,
                           shape.seq_len)
    return tree_map(lambda sd, ps: TensorSpec(tuple(sd[0]), sd[1],
                                              tuple(ps)),
                    tree, specs)


def concrete_inputs(cfg: ModelConfig, shape: ShapeConfig, seed: int = 0, *,
                    device=None) -> dict:
    """Real (small) inputs matching ``input_specs`` without a mesh, drawn
    from ``np.random.default_rng(seed)`` leaf by leaf in its order as the
    JAX package draws them: integers uniform below the vocabulary, floats
    standard normal. On ``device`` (the GPU unless ``device="cpu"``)."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    out = {}
    for k, ts in input_specs(cfg, shape, ParallelConfig(), None).items():
        if ts.dtype == torch.int32:
            a = rng.integers(0, cfg.vocab_size, size=ts.shape)
            a = a.astype(np.int32)
        else:
            a = rng.normal(size=ts.shape).astype(np.float32)
        out[k] = torch.from_numpy(a).to(device)
    return out
