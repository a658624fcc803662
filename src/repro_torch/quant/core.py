"""Block-wise expert-weight and KV-row quantization (counterpart of
``repro.quant.core``; the serving half: no ``fake_quant``/QAT, no
stochastic rounding, no gradient-compression helpers).

One rounding and clipping convention, bit for bit the JAX package's:

  q = clip(round(x / scale), -Q, Q)        scale = max(amax(block), 1e-30) / Q

symmetric, Q = 127 for int8 and 448 (the format's finite max) for fp8
e4m3, where the round is the cast's round to nearest even. ``torch.round``
rounds half to even as ``jnp.round`` does, the division is the same f32
division, and the clip comes before the cast. Scales are float32:

* expert weights: one per ``(expert, tile_row, tile_col)`` block of the
  trailing two dims (128 x 128, clamped to the dim); leading dims are batch;
* KV rows: one per written ``(token row, kv head)`` (``quantize_rows``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

#: Quantized-weight formats -> (storage dtype, symmetric max).
QUANT_FORMATS = {
    "int8": (torch.int8, 127.0),
    "fp8": (torch.float8_e4m3fn, 448.0),
}

#: The storage dtypes of quantized payloads, and each one's format name.
QUANT_MODES = {dt: mode for mode, (dt, _) in QUANT_FORMATS.items()}
QUANT_DTYPES = tuple(QUANT_MODES)

#: Expert-weight keys the parameter walkers quantize (routers, norms and
#: biases stay full precision).
EXPERT_WEIGHT_KEYS = ("w_gate", "w_up", "w_down", "w1", "w2")


def quant_bits(mode: Optional[str]) -> int:
    """Storage bits per weight element of a quant mode (16 for none)."""
    if mode in (None, "none"):
        return 16
    if mode not in QUANT_FORMATS:
        raise ValueError(f"unknown quant mode {mode!r}")
    return 8


# ---------------------------------------------------------------------------
# block-wise weight quantization
# ---------------------------------------------------------------------------

def block_tiles(shape: Sequence[int], tile: int) -> tuple:
    """Per-axis tile sizes over the trailing two dims: ``tile`` clamped to
    the dim (a dim smaller than the tile is one block). Larger dims must
    divide evenly."""
    a, b = int(shape[-2]), int(shape[-1])
    ta, tb = min(tile, a), min(tile, b)
    if a % ta or b % tb:
        raise ValueError(f"dims {(a, b)} not divisible by tiles {(ta, tb)}")
    return ta, tb


def _blocks(x: torch.Tensor, na: int, nb: int) -> torch.Tensor:
    """(..., A, B) viewed as (..., na, A/na, nb, B/nb) blocks."""
    *batch, a, b = x.shape
    return x.reshape(*batch, na, a // na, nb, b // nb)


def quantize_blockwise(w: torch.Tensor, *, mode: str = "int8",
                       tile: int = 128) -> tuple:
    """Quantize ``w`` block-wise over its trailing two dims. Returns ``(q,
    scales)``: ``q`` int8/fp8-e4m3 shaped like ``w``, ``scales`` float32
    ``(*batch, A/tile_a, B/tile_b)``."""
    if mode not in QUANT_FORMATS:
        raise ValueError(f"unknown quant mode {mode!r}")
    dtype, qmax = QUANT_FORMATS[mode]
    ta, tb = block_tiles(w.shape, tile)
    a, b = w.shape[-2:]
    blocks = _blocks(w.float(), a // ta, b // tb)
    amax = blocks.abs().amax(dim=(-3, -1))
    scales = amax.clamp_min(1e-30) / qmax
    x = blocks / scales[..., :, None, :, None]
    if mode == "int8":
        x = torch.round(x)
    q = x.clamp_(-qmax, qmax).to(dtype)
    return q.reshape(w.shape), scales


def dequantize_blockwise(q: torch.Tensor, scales: torch.Tensor,
                         dtype=torch.float32) -> torch.Tensor:
    """Inverse of ``quantize_blockwise``; the tiles follow from the q and
    scales shapes."""
    na, nb = scales.shape[-2:]
    x = _blocks(q.float(), na, nb) * scales.float()[..., :, None, :, None]
    return x.reshape(q.shape).to(dtype)


def scale_block_dims(wdims, sdims, bdims) -> tuple:
    """Block dims of a scale operand congruent with its weight block: for
    each trailing weight axis (extent ``wdims``, ``sdims`` scale blocks,
    kernel block ``bdims``) the quant tile ``wdim // sdim`` must divide the
    kernel block, which then covers ``bdim // tile`` scales."""
    out = []
    for d, s, b in zip(wdims, sdims, bdims):
        t = d // s
        if b % t:
            raise ValueError(f"quant tile {t} does not divide kernel block "
                             f"{b} (dim {d}, {s} scale blocks)")
        out.append(b // t)
    return tuple(out)


def dequant_tile(w: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """One 2-D weight tile ``w`` (A, B) times its congruent (na, nb) scale
    tile, in float32: the dequant the TPU kernels run in VMEM."""
    na, nb = s.shape
    return (_blocks(w.float(), na, nb)
            * s.float()[:, None, :, None]).reshape(w.shape)


def check_scales(name: str, weights, scales, blocks=None) -> list:
    """The contract of quantized kernel operands: 8-bit payloads of one
    dtype, each with f32 block scales ``(E, rows / ta, cols / tb)`` whose
    per-axis tiles ``(ta, tb)`` divide the payload's trailing dims (and,
    where ``blocks`` gives each weight's kernel block, that block, as
    ``scale_block_dims`` asks). Returns each weight's ``(ta, tb)``."""
    if len(scales) != len(weights):
        raise ValueError(f"{name}: {len(scales)} scale arrays for "
                         f"{len(weights)} weights")
    wdt = weights[0].dtype
    if wdt not in QUANT_DTYPES or any(w.dtype != wdt for w in weights):
        raise TypeError(f"{name}: quantized weights are int8 or "
                        f"float8_e4m3fn payloads of one dtype, got "
                        f"{[w.dtype for w in weights]}")
    tiles = []
    for i, (w, s) in enumerate(zip(weights, scales)):
        if not isinstance(s, torch.Tensor) or s.dtype != torch.float32:
            raise TypeError(f"{name}: scales must be float32 tensors")
        if s.ndim != 3 or w.ndim != 3 or s.shape[0] != w.shape[0]:
            raise ValueError(f"{name}: scales {tuple(s.shape)} do not "
                             f"match weight {tuple(w.shape)}")
        (rows, cols), (na, nb) = w.shape[1:], s.shape[1:]
        if not na or not nb or rows % na or cols % nb:
            raise ValueError(f"{name}: a {na} x {nb} scale grid does not "
                             f"tile a {rows} x {cols} weight")
        if blocks is not None:
            scale_block_dims((rows, cols), (na, nb), blocks[i])
        tiles.append((rows // na, cols // nb))
    return tiles


# ---------------------------------------------------------------------------
# KV-row quantization (paged cache payloads)
# ---------------------------------------------------------------------------

def quantize_rows(x: torch.Tensor) -> tuple:
    """Per-row symmetric int8 over the trailing (head_dim) axis: (int8
    rows, float32 scales shaped ``x.shape[:-1]``), one scale per written
    (token row, kv head), so resident pages never re-scale."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1).clamp_min(1e-30) / 127.0
    q = torch.round(xf / scale[..., None]).clamp_(-127, 127)
    return q.to(torch.int8), scale


def dequantize_rows(q: torch.Tensor, scale: torch.Tensor,
                    dtype=torch.float32) -> torch.Tensor:
    """Inverse of ``quantize_rows`` (the scale broadcasts over the row)."""
    return (q.float() * scale[..., None].float()).to(dtype)


# ---------------------------------------------------------------------------
# parameter-tree walkers
# ---------------------------------------------------------------------------

def quantize_ffn(ffn: dict, *, mode: str = "int8", tile: int = 128) -> dict:
    """One MoE FFN dict with each ``EXPERT_WEIGHT_KEYS`` leaf replaced by
    its int8/fp8 payload and a ``<name>_scale`` float32 entry beside it;
    router and biases pass through."""
    out = dict(ffn)
    for name in EXPERT_WEIGHT_KEYS:
        w = ffn.get(name)
        if w is None or f"{name}_scale" in ffn:
            continue
        out[name], out[f"{name}_scale"] = quantize_blockwise(
            w, mode=mode, tile=tile)
    return out


def ffn_scales(ffn: dict) -> Optional[dict]:
    """The ``<name>_scale`` entries of a (possibly) quantized FFN dict, or
    None when it holds full-precision weights."""
    s = {k: v for k, v in ffn.items() if k.endswith("_scale")}
    return s or None


def quantize_lm_params(params: dict, cfg, *, mode: str = "int8",
                       tile: int = 128) -> dict:
    """Quantize every MoE layer's expert weights of an LM parameter tree
    (the port's per-layer list), IN PLACE: each layer's ``ffn`` dict is
    replaced as soon as it is quantized, so its full-precision expert
    leaves are dropped one layer at a time and the whole tree never exists
    twice (61 GB of bf16 beside a 29 GB int8 copy would not fit a card).
    Returns ``params``. Attention, norms, embeddings and routers stay full
    precision."""
    for i, layer in enumerate(params["layers"]):
        if cfg.is_moe_layer(i) and "ffn" in layer:
            layer["ffn"] = quantize_ffn(layer["ffn"], mode=mode, tile=tile)
    return params
