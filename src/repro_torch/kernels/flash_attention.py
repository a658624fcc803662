"""Causal or full online-softmax self-attention, forward only (counterpart
of ``repro.kernels.flash_attention``).

No model path of either package calls it: training and prefill attention
is ``models.attention.chunked_attention``. Its entry point is the path.

* ``flash_attention`` — the wrapper, with the JAX GQA wrapper's contract:
  q (B, S, Hq, hd), k and v (B, S, Hkv, hd) -> (B, S, Hq, hd) in q's
  dtype, scale hd^-0.5, query head h reading kv head h // (Hq / Hkv) (what
  ``jnp.repeat(k, g, axis=2)`` gives). On a CUDA tensor it launches the
  hand-written kernel of ``csrc/flash_attention.cu`` (see its source note
  for the design) on the route ``_route`` picks from the dtype alone:
  ``"wgmma"`` (bf16 on the tensor cores, P V in split bf16) or ``"simt"``
  (f32 FMA), and counts the launch in ``flash_attention.launches`` and
  ``flash_attention.launches_by_route``; on a CPU tensor it runs
  ``flash_attention_plain``. There is no other path, and no route gives
  way to another. ``bq`` and ``bk`` are the TPU kernel's block sizes: S must be a
  multiple of ``min(bq, S)`` and of ``min(bk, S)`` (ValueError otherwise,
  where the TPU kernel asserts); the plain version walks those blocks,
  the CUDA kernel tiles by its own sizes.
* ``flash_attention_plain`` — the plain PyTorch version: the TPU kernel's
  algorithm over (q block, kv block) pairs, vectorised over batch and
  heads, with f32 products and running (m, l, acc), masked logits at
  ``NEG_INF`` and blocks above the diagonal skipped when causal. It never
  holds more than one (bq, bk) block of logits per head.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

NEG_INF = -2.0e38

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128, 256)      # the kernel's instances
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_VP] * 4 + [_I] * 6 + [_F, _I, _VP]
_WG_ARGTYPES = [_VP] * 4 + [_I] * 6 + [_F, _VP]
_ROUTES = ("simt", "wgmma")


def _route(dtype) -> str:
    """The kernel route: ``"wgmma"`` for bf16 (every head dim the kernel
    takes), ``"simt"`` for f32."""
    return "wgmma" if dtype == torch.bfloat16 else "simt"


def _check_args(q, k, v, bq, bk):
    """What both paths refuse: the TPU wrapper's shape contract, the two
    dtypes, and S not a multiple of the block sizes."""
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention takes q (B, S, Hq, hd) and k, v "
                         f"(B, S, Hkv, hd), got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, s, hq, hd = q.shape
    hkv = k.shape[2]
    if k.shape[0] != b or k.shape[1] != s or k.shape[3] != hd or hkv == 0 \
            or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit k, v "
                         f"{tuple(k.shape)} (self-attention, Hq % Hkv == 0)")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_attention takes float32 or bfloat16 q, k and "
                        f"v of one dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
    if s == 0 or bq <= 0 or bk <= 0 or s % min(bq, s) or s % min(bk, s):
        raise ValueError(f"S {s} is not a multiple of min(bq, S) and "
                         f"min(bk, S) (bq {bq}, bk {bk})")
    return b, s, hq, hkv, hd


def _check_cuda_args(q, k, v, bq, bk):
    b, s, hq, hkv, hd = _check_args(q, k, v, bq, bk)
    if hd not in _HEAD_DIMS:
        raise ValueError(f"the flash_attention kernel takes head dims "
                         f"{_HEAD_DIMS}, got {hd}")
    tensors = (q, k, v)
    if any(t.device != q.device for t in tensors):
        raise ValueError("flash_attention operands lie on different devices")
    if any(not t.is_contiguous() or t.data_ptr() % 16 for t in tensors):
        raise ValueError("flash_attention operands must be contiguous and "
                         "16-byte aligned")
    return b, s, hq, hkv, hd


def flash_attention_plain(q, k, v, *, causal: bool = True, bq: int = 512,
                          bk: int = 512) -> torch.Tensor:
    """Plain PyTorch flash attention, block by block as the TPU kernel."""
    b, s, hq, hkv, hd = _check_args(q, k, v, bq, bk)
    g = hq // hkv
    bq, bk = min(bq, s), min(bk, s)
    scale = hd ** -0.5
    qg = q.reshape(b, s, hkv, g, hd).permute(0, 2, 3, 1, 4)   # (B,Hkv,G,S,hd)
    kt = k.permute(0, 2, 1, 3)                                 # (B,Hkv,S,hd)
    vt = v.permute(0, 2, 1, 3)
    out = torch.empty((b, hkv, g, s, hd), dtype=q.dtype, device=q.device)
    for i in range(s // bq):
        qi = qg[:, :, :, i * bq:(i + 1) * bq].float()
        m = torch.full((b, hkv, g, bq, 1), NEG_INF, device=q.device)
        l = torch.zeros((b, hkv, g, bq, 1), device=q.device)
        acc = torch.zeros((b, hkv, g, bq, hd), device=q.device)
        qpos = i * bq + torch.arange(bq, device=q.device)
        for j in range(s // bk):
            if causal and j * bk > i * bq + bq - 1:
                break                     # above the diagonal: no live key
            kj = kt[:, :, j * bk:(j + 1) * bk].float()
            vj = vt[:, :, j * bk:(j + 1) * bk].float()
            logits = torch.einsum("bhgqd,bhkd->bhgqk", qi, kj) * scale
            if causal:
                kpos = j * bk + torch.arange(bk, device=q.device)
                logits = torch.where(kpos[None, :] <= qpos[:, None], logits,
                                     NEG_INF)
            m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
            alpha = torch.exp(m - m_new)
            p = torch.exp(logits - m_new)
            l = l * alpha + p.sum(dim=-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhgqk,bhkd->bhgqd", p, vj)
            m = m_new
        out[:, :, :, i * bq:(i + 1) * bq] = (
            acc / torch.clamp(l, min=1e-30)).to(q.dtype)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, hd)


def flash_attention(q, k, v, *, causal: bool = True, bq: int = 512,
                    bk: int = 512) -> torch.Tensor:
    """GQA self-attention: q (B, S, Hq, hd), k/v (B, S, Hkv, hd) ->
    (B, S, Hq, hd) in q's dtype."""
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal, bq=bq, bk=bk)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on CUDA or CPU, not "
                         f"{q.device}")
    b, s, hq, hkv, hd = _check_cuda_args(q, k, v, bq, bk)
    route = _route(q.dtype)
    out = torch.empty_like(q)
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s,
            hq, hkv, hd, int(causal), float(hd ** -0.5))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if route == "wgmma":
            launch = build.load("flash_attention",
                                "flash_attention_wgmma_launch", _WG_ARGTYPES)
            err = launch(*args, stream)
        else:
            launch = build.load("flash_attention", "flash_attention_launch",
                                _ARGTYPES)
            err = launch(*args, _DTYPES[q.dtype], stream)
    if err:
        raise RuntimeError(f"flash_attention kernel launch failed on the "
                           f"{route} route (CUDA error {err})")
    flash_attention.launches += 1
    flash_attention.launches_by_route[route] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(_ROUTES, 0)
