"""Paged decode attention over a shared KV page pool (counterpart of
``repro.kernels.paged_attention``).

* ``paged_attention`` — the wrapper. On a CUDA tensor it launches the
  hand-written kernel of ``csrc/paged_attention.cu`` (the port of
  ``paged_attention_pallas``; see its source note for the design) and
  counts the launch in ``paged_attention.launches``; on a CPU tensor it
  runs ``paged_attention_ref``. There is no other path.
* ``paged_attention_ref`` — the plain PyTorch version (the port of the JAX
  ``paged_attention_ref``): gather each slot's pages to a dense
  (B, maxp*page) view and run masked softmax attention.

The kernel splits the pages of a slot across CTAs: ``pages_per_split``
gives each split's run of logical pages from the table width ``maxp``
alone (the lengths stay on the device), and with more than one split the
partial softmax states go through a workspace that the wrapper keeps per
device (``_workspace``), so a call allocates nothing after the first.
Calls that share the workspace must not overlap: launch them on one
stream of the device, as the port does.

int8 pools (``k_scale``/``v_scale``, one f32 scale per (row, kv head),
``quant.core.quantize_rows``): on a CUDA tensor the same kernel reads the
int8 rows and their scales and dequantizes them as they land
(``paged_attention_q_launch``), counted in ``launches`` and in
``paged_attention.launches_quant["int8"]``; on a CPU tensor
``paged_attention_ref`` dequantizes the gathered pages to q's dtype first,
as the JAX reference does.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.quant.core import dequantize_rows

NEG_INF = -2.0e38

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = [_VP] * 8 + [_I] * 8 + [_F, _F, _I, _VP]
_Q_ARGTYPES = [_VP] * 10 + [_I] * 8 + [_F, _F, _I, _VP]
#: What the kernel takes: hd a multiple of 16 up to 256, G = Hq / Hkv up
#: to 16, pages of 4 to 32 tokens in multiples of 4, at most 64 splits.
MAX_HD, MAX_G, MAX_PAGE, MAX_SPLITS = 256, 16, 32, 64
_MIN_PAGES_PER_SPLIT = 4

# device index -> (partials f32, tickets int32); tickets are 0 between calls
_WORKSPACE = {}


def pages_per_split(maxp: int) -> int:
    """Logical pages of a split: at least 4, and few enough that a table
    of ``maxp`` pages makes at most ``MAX_SPLITS`` splits (32 pages at
    qwen3's 32,768-token context in 16-token pages; one split at the serve
    path's 2-page tables)."""
    return max(_MIN_PAGES_PER_SPLIT, -(-maxp // MAX_SPLITS))


def num_splits(maxp: int) -> int:
    """CTAs a (slot, kv head): ceil(maxp / pages_per_split(maxp))."""
    return -(-maxp // pages_per_split(maxp))


def _workspace(device, b, hkv, splits, g, hd):
    """The kernel's partials (B, Hkv, splits, G*hd + 2G) f32 and tickets
    (B, Hkv) int32, from buffers kept per device that only ever grow."""
    floats, tickets = b * hkv * splits * (g * hd + 2 * g), b * hkv
    have = _WORKSPACE.get(device.index)
    if have is None or have[0].numel() < floats or have[1].numel() < tickets:
        floats = max(floats, 0 if have is None else have[0].numel())
        tickets = max(tickets, 0 if have is None else have[1].numel())
        have = (torch.empty(floats, dtype=torch.float32, device=device),
                torch.zeros(tickets, dtype=torch.int32, device=device))
        _WORKSPACE[device.index] = have
    return have


def paged_attention_ref(
    q: torch.Tensor,           # (B, 1, Hq, hd)
    k_pool: torch.Tensor,      # (npages, page, Hkv, hd)
    v_pool: torch.Tensor,
    page_table: torch.Tensor,  # (B, maxp) int32
    lengths: torch.Tensor,     # (B,) int32, live tokens incl. the current one
    *,
    k_scale: Optional[torch.Tensor] = None,   # (npages, page, Hkv) f32
    v_scale: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    softcap: float = 0.0,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Gather-dense paged decode attention: f32 logits, masked softmax,
    probabilities rounded to the pool dtype before the value product (as
    the JAX reference does), an empty slot gives zeros. int8 pools are
    dequantized page by gathered page to q's dtype."""
    b, _, hq, hd = q.shape
    _, page, hkv, _ = k_pool.shape
    maxp = page_table.shape[1]
    g = hq // hkv
    scale = hd ** -0.5 if scale is None else scale
    s = maxp * page
    pt = page_table.long()

    def view(pool, sc):
        gathered = pool[pt]                   # (B, maxp, page, Hkv, hd)
        if sc is not None:
            gathered = dequantize_rows(gathered, sc[pt], dtype=q.dtype)
        return gathered.reshape(b, s, hkv, hd)

    k_v = view(k_pool, k_scale)
    v_v = view(v_pool, v_scale)
    qg = q.reshape(b, hkv, g, hd)
    logits = torch.einsum("bhgd,bshd->bhgs", qg.float(), k_v.float()) * scale
    if softcap:
        logits = torch.tanh(logits / softcap) * softcap
    kpos = torch.arange(s, device=q.device)[None, :]
    lens = lengths.long()[:, None]
    valid = kpos < lens
    if window is not None:
        valid &= kpos >= lens - window
    logits = torch.where(valid[:, None, None, :], logits, NEG_INF)
    p = torch.softmax(logits, dim=-1)
    p = torch.where(lens[:, :, None, None] > 0, p, 0.0)
    out = torch.einsum("bhgs,bshd->bhgd", p.to(v_v.dtype).float(), v_v.float())
    return out.reshape(b, 1, hq, hd).to(q.dtype)


def _check_scales(k_pool, v_pool, k_scale, v_scale):
    """int8 pools go with f32 per-(row, kv head) scale pools."""
    if (k_scale is None) != (v_scale is None):
        raise ValueError("k_scale and v_scale come together")
    if k_scale is None:
        return
    if k_pool.dtype != torch.int8 or v_pool.dtype != torch.int8:
        raise TypeError(f"scaled pools are int8, got {k_pool.dtype}, "
                        f"{v_pool.dtype}")
    if k_scale.dtype != torch.float32 or v_scale.dtype != torch.float32:
        raise TypeError("k_scale and v_scale must be float32")
    if k_scale.shape != k_pool.shape[:3] or v_scale.shape != v_pool.shape[:3]:
        raise ValueError(f"scale pools {tuple(k_scale.shape)}, "
                         f"{tuple(v_scale.shape)} are not (npages, page, "
                         f"Hkv) of pools {tuple(k_pool.shape)}")


def _check_cuda_args(q, k_pool, v_pool, page_table, lengths, k_scale=None,
                     v_scale=None):
    b, one, hq, hd = q.shape
    _, page, hkv, hd_k = k_pool.shape
    if one != 1 or hd_k != hd or v_pool.shape != k_pool.shape or hq % hkv:
        raise ValueError(f"q {tuple(q.shape)} does not fit pools "
                         f"{tuple(k_pool.shape)}")
    _check_scales(k_pool, v_pool, k_scale, v_scale)
    pool_dtype = q.dtype if k_scale is None else torch.int8
    if q.dtype not in _DTYPES or k_pool.dtype != pool_dtype \
            or v_pool.dtype != pool_dtype:
        raise TypeError(f"paged_attention takes float32 or bfloat16 q and "
                        f"pools of the same dtype (or int8 with scales), got "
                        f"{q.dtype}, {k_pool.dtype}")
    if page_table.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("page_table and lengths must be int32")
    if page_table.shape[0] != b or lengths.shape != (b,):
        raise ValueError(f"page_table {tuple(page_table.shape)} / lengths "
                         f"{tuple(lengths.shape)} do not match {b} slots")
    if hd % 16 or hd > MAX_HD or hq // hkv > MAX_G or page % 4 \
            or not 4 <= page <= MAX_PAGE:
        raise ValueError(f"paged_attention's kernel takes hd a multiple of "
                         f"16 up to {MAX_HD}, up to {MAX_G} query heads a kv "
                         f"head and pages of 4 to {MAX_PAGE} tokens in "
                         f"multiples of 4, not hd {hd}, G {hq // hkv}, page "
                         f"{page}")
    tensors = [t for t in (q, k_pool, v_pool, page_table, lengths, k_scale,
                           v_scale) if t is not None]
    if any(t.device != q.device for t in tensors):
        raise ValueError("paged_attention operands lie on different devices")
    if any(not t.is_contiguous() for t in tensors):
        raise ValueError("paged_attention operands must be contiguous")
    return b, hq, hkv, hd, page, page_table.shape[1]


def paged_attention(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    page_table: torch.Tensor,
    lengths: torch.Tensor,
    *,
    k_scale: Optional[torch.Tensor] = None,
    v_scale: Optional[torch.Tensor] = None,
    window: Optional[int] = None,
    softcap: float = 0.0,
) -> torch.Tensor:
    """One query row per slot against its K/V pages: q (B, 1, Hq, hd),
    pools (npages, page, Hkv, hd), page_table (B, maxp) int32, lengths (B,)
    int32 -> (B, 1, Hq, hd). int8 pools take their f32 scale pools
    ``k_scale``/``v_scale`` (npages, page, Hkv)."""
    _check_scales(k_pool, v_pool, k_scale, v_scale)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, page_table, lengths,
                                   k_scale=k_scale, v_scale=v_scale,
                                   window=window, softcap=softcap)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention runs on CUDA or CPU, not {q.device}")
    b, hq, hkv, hd, page, maxp = _check_cuda_args(
        q, k_pool, v_pool, page_table, lengths, k_scale, v_scale)
    out = torch.empty_like(q)
    pps = pages_per_split(maxp)
    splits = num_splits(maxp)
    parts = tickets = None
    if splits > 1:
        parts, tickets = (t.data_ptr() for t in _workspace(
            q.device, b, hkv, splits, hq // hkv, hd))
    tail = (page_table.data_ptr(), lengths.data_ptr(), out.data_ptr(), parts,
            tickets, b, hq, hkv, hd, page, maxp, pps, int(window or 0),
            float(softcap or 0.0), float(hd ** -0.5), _DTYPES[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if k_scale is None:
            launch = build.load("paged_attention", "paged_attention_launch",
                                _ARGTYPES)
            err = launch(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                         *tail, stream)
        else:
            launch = build.load("paged_attention", "paged_attention_q_launch",
                                _Q_ARGTYPES)
            err = launch(q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                         k_scale.data_ptr(), v_scale.data_ptr(), *tail,
                         stream)
    if err:
        raise RuntimeError(
            f"paged_attention kernel launch failed (CUDA error {err})")
    paged_attention.launches += 1
    if k_scale is not None:
        paged_attention.launches_quant["int8"] += 1
    return out


paged_attention.launches = 0
paged_attention.launches_quant = {"int8": 0}
