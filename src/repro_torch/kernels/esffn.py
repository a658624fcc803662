"""ESFFN — the fused expert FFNs (paper Fig. 3 / Table 5 forward;
counterparts of ``repro.kernels.esffn.esffn_glu_pallas`` and
``esffn_mlp_pallas``).

One op runs the whole expert FFN over the expert-sorted layout:
gather -> up (and gate) -> activation -> down -> gate weighting. Token
rows are gathered straight from the unsorted (N, D) activations through
``row_token``, and the output is the gate-weighted sorted (Np, D) rows
that ``core.reindex.scatter_rows`` combines. Two expert bodies:

* ``esffn_glu`` — ``(act(x Wg) * (x Wu)) Wd`` (Mixtral / Qwen3 experts);
* ``esffn_mlp`` — ``act(x W1 + b1) W2 + b2`` with optional f32 biases
  (the paper's 2-MLP expert, Swin-MoE); b2 is added once per row inside
  the gate product.

Each wrapper launches, on a CUDA tensor, the hand-written kernel of
``csrc/esffn.cu`` (see its source note for the design) and counts the
launch in ``<wrapper>.launches``; on a CPU tensor it runs its plain
version. There is no other path. ``esffn_glu`` has two routes, picked by
``_route`` from the dtype and shapes alone before the launch and counted
in ``esffn_glu.launches_by_route``: ``"wgmma"`` (bf16 on the tensor cores;
the LM train path at blk 128) and ``"stream"`` (the weight-streaming
kernels: the serve path at blk 16, 8-bit weights, f32). ``esffn_mlp``
runs on the tensor cores through ``mma.sync`` on two routes, picked by
``_mlp_route`` and counted in ``esffn_mlp.launches_by_route``:
``"mma_tf32x3"`` (f32 x, and every call with 8-bit weights: each f32
operand split into two TF32 parts, three products summed in f32) and
``"mma_bf16"`` (bf16 x and weights). No route gives way to another. The
plain versions (``*_plain``) use
per-block weight tiles ``W[block_expert]`` and batched matmuls, rounding
where the kernels round: g and u (GLU) or z after ``+ b1`` (MLP) to
x.dtype, h in x.dtype, the down product in f32 (from b2), the output
``(acc * gate)`` to x.dtype.

Quantized weights (``w_scales``): int8 or fp8 e4m3 payloads with f32
block scales on each weight's own two axes (``quant.core``). On a CUDA
tensor the same kernels run on the 8-bit payload and dequantize each
weight element where they read it (``esffn_glu_q_launch``,
``esffn_mlp_q_launch``), counted in ``<wrapper>.launches`` and in
``<wrapper>.launches_quant`` by format; on a CPU tensor the plain version
dequantizes the whole weight (``dequantize_blockwise``, f32) first and
multiplies x promoted to f32, as the TPU kernel's f32 dequantized tile
meets its x.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.common import ACT_IDS, ACTIVATIONS
from repro_torch.core.reindex import gather_rows
from repro_torch.kernels import build
from repro_torch.quant.core import (QUANT_MODES, check_scales,
                                    dequantize_blockwise)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: 8-bit weight storage -> the C entry points' wdtype.
_WDTYPES = {torch.int8: 1, torch.float8_e4m3fn: 2}
_VP, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_VP] * 9 + [_I] * 7 + [_VP]
_ROUTES = ("stream", "wgmma")
_MLP_ROUTES = ("mma_tf32x3", "mma_bf16")
_MLP_ARGTYPES = [_VP] * 10 + [_I] * 7 + [_VP]
_Q_ARGTYPES = [_VP] * 12 + [_I] * 12 + [_VP]
#: The TPU kernels' hidden-dim block (``bf``): the quant tiles must divide
#: their weight blocks (``scale_block_dims``), and the wrappers refuse what
#: the TPU kernels refuse.
_TPU_BF = 128


def _dequantized(weights, w_scales):
    """The f32 weights of 8-bit payloads (``w_scales``), or the weights
    themselves."""
    if w_scales is None:
        return weights
    return [dequantize_blockwise(w, s) for w, s in zip(weights, w_scales)]


def _tpu_blocks(d, f, up_down):
    """The TPU kernels' weight blocks: (D, bf) for an up weight (E, D, F),
    (bf, D) for a down weight (E, F, D)."""
    bf = min(_TPU_BF, f)
    return [(d, bf) if up else (bf, d) for up in up_down]


def _route(dtype, blk: int, d: int, f: int, quantized: bool = False) -> str:
    """The GLU kernel route for these operands: ``"wgmma"`` for bf16 x with
    bf16 weights, ``blk % 64 == 0`` and D and F multiples of 8 (TMA takes
    16-byte global strides), else ``"stream"`` (bf16 at blk 8..32, f32,
    and every call with 8-bit weights)."""
    if dtype == torch.bfloat16 and not quantized and blk % 64 == 0 \
            and d % 8 == 0 and f % 8 == 0:
        return "wgmma"
    return "stream"


def esffn_glu_plain(x, row_token, row_gate, block_expert, w_gate, w_up,
                    w_down, *, w_scales=None, act: str = "silu") -> torch.Tensor:
    """Plain PyTorch fused GLU expert FFN: (N, D) tokens -> (Np, D)
    gate-weighted sorted rows. Sentinel rows gather zeros (the kernels
    clamp them to row N-1); either way their zero gate makes them 0.
    8-bit weights (``w_scales``) are dequantized to f32, and the up
    products taken in x promoted to the weights' dtype (as JAX promotes a
    bf16 x against the TPU kernel's f32 dequantized tile) before g and u
    round to x.dtype."""
    np_rows = row_token.shape[0]
    nblk = block_expert.shape[0]
    blk = np_rows // nblk
    w_gate, w_up, w_down = _dequantized((w_gate, w_up, w_down), w_scales)
    wdt = torch.promote_types(x.dtype, w_gate.dtype)
    xb = gather_rows(x, row_token).reshape(nblk, blk, -1).to(wdt)
    be = block_expert.long()
    g = torch.bmm(xb, w_gate[be].to(wdt)).to(x.dtype)
    u = torch.bmm(xb, w_up[be].to(wdt)).to(x.dtype)
    h = ACTIVATIONS[act](g) * u
    acc = torch.bmm(h.float(), w_down[be].float())
    out = acc * row_gate.reshape(nblk, blk, 1).float()
    return out.to(x.dtype).reshape(np_rows, -1)


def _check_layout(name, x, row_token, row_gate, block_expert, act,
                  tensors):
    """The checks both FFN kernels share: the row maps, the block size,
    the activation, and one device and contiguity for ``tensors``.
    Returns (Np, blk)."""
    if (row_token.dtype != torch.int32 or block_expert.dtype != torch.int32
            or row_gate.dtype != torch.float32):
        raise TypeError("row_token/block_expert must be int32, row_gate f32")
    np_rows, nblk = row_token.shape[0], block_expert.shape[0]
    if row_gate.shape != (np_rows,) or nblk == 0 or np_rows % nblk:
        raise ValueError(f"layout of {np_rows} rows in {nblk} blocks")
    blk = np_rows // nblk
    if blk % 8 or not 8 <= blk <= 128:
        raise ValueError(f"blk {blk}: the kernel takes multiples of 8 up "
                         f"to 128")
    if act not in ACT_IDS:
        raise ValueError(f"unknown activation {act!r}")
    if any(t.device != x.device for t in tensors):
        raise ValueError(f"{name} operands lie on different devices")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} operands must be contiguous")
    return np_rows, blk


def _check_cuda_args(x, row_token, row_gate, block_expert, w_gate, w_up,
                     w_down, act, w_scales=None):
    n, d = x.shape
    e, dw, f = w_gate.shape
    if dw != d or w_up.shape != (e, d, f) or w_down.shape != (e, f, d):
        raise ValueError(f"weight shapes {tuple(w_gate.shape)}, "
                         f"{tuple(w_up.shape)}, {tuple(w_down.shape)} do not "
                         f"match x {tuple(x.shape)}")
    weights = (w_gate, w_up, w_down)
    if w_scales is not None:
        check_scales("esffn_glu", weights, w_scales,
                     _tpu_blocks(d, f, (True, True, False)))
    if x.dtype not in _DTYPES or (w_scales is None and any(
            w.dtype != x.dtype for w in weights)):
        raise TypeError(f"esffn_glu takes float32 or bfloat16 x and weights "
                        f"of the same dtype, got {x.dtype}, {w_gate.dtype}")
    np_rows, blk = _check_layout(
        "esffn_glu", x, row_token, row_gate, block_expert, act,
        (x, row_token, row_gate, block_expert, *weights, *(w_scales or ())))
    route = _route(x.dtype, blk, d, f, w_scales is not None)
    if route == "stream":
        if d % 16 or f % 16:
            raise ValueError(f"esffn_glu's stream route copies weight rows in "
                             f"16-byte pieces: D {d} and F {f} must be "
                             f"multiples of 16")
        if w_scales is not None and any(
                w.shape[2] // s.shape[2] % 8 for w, s in zip(weights,
                                                             w_scales)):
            raise ValueError("esffn_glu's stream route takes 8-bit weights "
                             "whose column quant tiles are multiples of 8")
    if any(t.data_ptr() % 16 for t in (x, *weights)):
        raise ValueError(f"esffn_glu's {route} route copies x and the "
                         f"weights in 16-byte pieces, which needs 16-byte "
                         f"aligned base addresses")
    return n, d, f, np_rows, blk


def esffn_glu(x, row_token, row_gate, block_expert, w_gate, w_up, w_down, *,
              w_scales=None, act: str = "silu") -> torch.Tensor:
    """Fused GLU expert FFN: (N, D) unsorted tokens -> (Np, D) gate-weighted
    sorted output. x: (N, D); row_token/row_gate: (Np,) int32/f32 and
    block_expert: (Np // blk,) int32 from ``core.reindex.build_reindex``;
    w_gate/w_up: (E, D, F); w_down: (E, F, D). ``w_scales``: (sg, su, sd),
    the f32 block scales of int8/fp8 weights."""
    if w_scales is not None:
        w_scales = tuple(w_scales)
        tiles = check_scales("esffn_glu", (w_gate, w_up, w_down), w_scales)
    if x.device.type == "cpu":
        return esffn_glu_plain(x, row_token, row_gate, block_expert,
                               w_gate, w_up, w_down, w_scales=w_scales,
                               act=act)
    if x.device.type != "cuda":
        raise ValueError(f"esffn_glu runs on CUDA or CPU, not {x.device}")
    n, d, f, np_rows, blk = _check_cuda_args(
        x, row_token, row_gate, block_expert, w_gate, w_up, w_down, act,
        w_scales)
    route = _route(x.dtype, blk, d, f, w_scales is not None)
    out = torch.empty((np_rows, d), dtype=x.dtype, device=x.device)
    h = torch.empty((np_rows, f), dtype=x.dtype, device=x.device)
    ptrs = (x.data_ptr(), row_token.data_ptr(), row_gate.data_ptr(),
            block_expert.data_ptr(), w_gate.data_ptr(), w_up.data_ptr(),
            w_down.data_ptr())
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "wgmma":
            launch = build.load("esffn", "esffn_glu_wgmma_launch",
                                _ARGTYPES)
            err = launch(*ptrs, h.data_ptr(), out.data_ptr(), n, d, f,
                         np_rows, blk, ACT_IDS[act], w_gate.shape[0], stream)
        elif w_scales is None:
            launch = build.load("esffn", "esffn_glu_launch", _ARGTYPES)
            err = launch(*ptrs, h.data_ptr(), out.data_ptr(), n, d, f,
                         np_rows, blk, _DTYPES[x.dtype], ACT_IDS[act], stream)
        else:
            (ta_up, tb_up), _, (ta_dn, tb_dn) = tiles
            launch = build.load("esffn", "esffn_glu_q_launch", _Q_ARGTYPES)
            err = launch(*ptrs, *(s.data_ptr() for s in w_scales),
                         h.data_ptr(), out.data_ptr(), n, d, f, np_rows, blk,
                         _DTYPES[x.dtype], _WDTYPES[w_gate.dtype],
                         ACT_IDS[act], ta_up, tb_up, ta_dn, tb_dn, stream)
    if err:
        raise RuntimeError(f"esffn_glu kernel launch failed on the {route} "
                           f"route (CUDA error {err})")
    esffn_glu.launches += 1
    esffn_glu.launches_by_route[route] += 1
    if w_scales is not None:
        esffn_glu.launches_quant[QUANT_MODES[w_gate.dtype]] += 1
    return out


esffn_glu.launches = 0
esffn_glu.launches_by_route = dict.fromkeys(_ROUTES, 0)
esffn_glu.launches_quant = dict.fromkeys(QUANT_MODES.values(), 0)


def _mlp_route(dtype, quantized: bool = False) -> str:
    """The 2-MLP kernel route: ``"mma_bf16"`` for bf16 x with bf16 weights,
    else ``"mma_tf32x3"`` (f32, and 8-bit weights dequantized to f32)."""
    return "mma_bf16" if dtype == torch.bfloat16 and not quantized \
        else "mma_tf32x3"


def esffn_mlp_plain(x, row_token, row_gate, block_expert, w1, b1, w2, b2, *,
                    w_scales=None, act: str = "gelu") -> torch.Tensor:
    """Plain PyTorch fused 2-MLP expert FFN: (N, D) tokens -> (Np, D)
    gate-weighted sorted rows. z sums in f32 and takes b1 in f32 before it
    is rounded to x.dtype; the down product sums in f32 from b2. 8-bit
    weights (``w_scales``) are dequantized to f32 first."""
    w1, w2 = _dequantized((w1, w2), w_scales)
    np_rows = row_token.shape[0]
    nblk = block_expert.shape[0]
    blk = np_rows // nblk
    xb = gather_rows(x, row_token).reshape(nblk, blk, -1)
    be = block_expert.long()
    z = torch.bmm(xb.float(), w1[be].float())
    if b1 is not None:
        z = z + b1[be].float()[:, None]
    h = ACTIVATIONS[act](z.to(x.dtype))
    acc = torch.bmm(h.float(), w2[be].float())
    if b2 is not None:
        acc = b2[be].float()[:, None] + acc
    out = acc * row_gate.reshape(nblk, blk, 1).float()
    return out.to(x.dtype).reshape(np_rows, -1)


def _check_mlp_cuda_args(x, row_token, row_gate, block_expert, w1, b1, w2,
                         b2, act, w_scales=None):
    n, d = x.shape
    e, dw, f = w1.shape
    if dw != d or w2.shape != (e, f, d):
        raise ValueError(f"weight shapes {tuple(w1.shape)}, "
                         f"{tuple(w2.shape)} do not match x {tuple(x.shape)}")
    for name, b, want in (("b1", b1, (e, f)), ("b2", b2, (e, d))):
        if b is not None and (b.shape != want or not b.is_floating_point()):
            raise ValueError(f"{name} {tuple(b.shape)} {b.dtype} is not a "
                             f"float (E, {want[1]}) bias")
    if w_scales is not None:
        check_scales("esffn_mlp", (w1, w2), w_scales,
                     _tpu_blocks(d, f, (True, False)))
    if x.dtype not in _DTYPES or (w_scales is None and (
            w1.dtype != x.dtype or w2.dtype != x.dtype)):
        raise TypeError(f"esffn_mlp takes float32 or bfloat16 x and weights "
                        f"of the same dtype, got {x.dtype}, {w1.dtype}, "
                        f"{w2.dtype}")
    np_rows, blk = _check_layout(
        "esffn_mlp", x, row_token, row_gate, block_expert, act,
        [t for t in (x, row_token, row_gate, block_expert, w1, b1, w2, b2,
                     *(w_scales or ())) if t is not None])
    if d % 8 or f % 8:
        raise ValueError(f"esffn_mlp's kernel stages rows in 8-element "
                         f"pieces: D {d} and F {f} must be multiples of 8")
    if any(t.data_ptr() % 16 for t in (x, w1, w2)):
        raise ValueError("esffn_mlp's kernel copies x and the weights in "
                         "16-byte pieces, which needs 16-byte aligned base "
                         "addresses")
    return n, d, f, np_rows, blk


def esffn_mlp(x, row_token, row_gate, block_expert, w1, b1, w2, b2, *,
              w_scales=None, act: str = "gelu") -> torch.Tensor:
    """Fused 2-MLP expert FFN: (N, D) unsorted tokens -> (Np, D)
    gate-weighted sorted output ``(act(x W1 + b1) W2 + b2) * gate``.
    w1: (E, D, F); w2: (E, F, D) in x.dtype; b1: (E, F) and b2: (E, D) or
    None, added in f32; row maps as for ``esffn_glu``. ``w_scales``: (s1,
    s2), the f32 block scales of int8/fp8 w1 and w2 (the biases stay full
    precision)."""
    if w_scales is not None:
        w_scales = tuple(w_scales)
        tiles = check_scales("esffn_mlp", (w1, w2), w_scales)
    if x.device.type == "cpu":
        return esffn_mlp_plain(x, row_token, row_gate, block_expert, w1, b1,
                               w2, b2, w_scales=w_scales, act=act)
    if x.device.type != "cuda":
        raise ValueError(f"esffn_mlp runs on CUDA or CPU, not {x.device}")
    n, d, f, np_rows, blk = _check_mlp_cuda_args(
        x, row_token, row_gate, block_expert, w1, b1, w2, b2, act, w_scales)
    b1, b2 = (None if b is None else b.float() for b in (b1, b2))
    out = torch.empty((np_rows, d), dtype=x.dtype, device=x.device)
    h = torch.empty((np_rows, f), dtype=x.dtype, device=x.device)
    b1p = None if b1 is None else b1.data_ptr()
    b2p = None if b2 is None else b2.data_ptr()
    head = (x.data_ptr(), row_token.data_ptr(), row_gate.data_ptr(),
            block_expert.data_ptr())
    tail = (h.data_ptr(), out.data_ptr(), n, d, f, np_rows, blk,
            _DTYPES[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if w_scales is None:
            launch = build.load("esffn", "esffn_mlp_launch", _MLP_ARGTYPES)
            err = launch(*head, w1.data_ptr(), b1p, w2.data_ptr(), b2p,
                         *tail, ACT_IDS[act], stream)
        else:
            (ta1, tb1), (ta2, tb2) = tiles
            s1, s2 = w_scales
            launch = build.load("esffn", "esffn_mlp_q_launch", _Q_ARGTYPES)
            err = launch(*head, w1.data_ptr(), s1.data_ptr(), b1p,
                         w2.data_ptr(), s2.data_ptr(), b2p, *tail,
                         _WDTYPES[w1.dtype], ACT_IDS[act], ta1, tb1, ta2,
                         tb2, stream)
    route = _mlp_route(x.dtype, w_scales is not None)
    if err:
        raise RuntimeError(f"esffn_mlp kernel launch failed on the {route} "
                           f"route (CUDA error {err})")
    esffn_mlp.launches += 1
    esffn_mlp.launches_by_route[route] += 1
    if w_scales is not None:
        esffn_mlp.launches_quant[QUANT_MODES[w1.dtype]] += 1
    return out


esffn_mlp.launches = 0
esffn_mlp.launches_by_route = dict.fromkeys(_MLP_ROUTES, 0)
esffn_mlp.launches_quant = dict.fromkeys(QUANT_MODES.values(), 0)
