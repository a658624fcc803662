"""ESFK — the expert-specific fused backward kernel over the expert-sorted
layout (paper Fig. 4(c)+(d); counterpart of
``repro.kernels.esfk.esfk_pallas``).

``dW[e] = sum_{rows i of e} x1[i]^T x2[i]`` and ``db[e] = sum_{rows i of e}
x2[i]`` in one pass, both f32: (E, D1, D2) and (E, D2); an expert whose
``counts`` entry is 0 gets exactly 0 in both. The biased MLP expert FFN's
backward computes (dW1, db1) and (dW2, db2) with it.

* ``esfk`` — the wrapper. On a CUDA tensor it launches the hand-written
  kernel of ``csrc/esfk.cu`` (see its source note for the design) on the
  route ``_route`` picks from the dtype and widths alone, before the
  launch: ``"mma_tf32x3"`` (f32, 3xTF32) or ``"mma_bf16"`` (bf16), both on
  the tensor cores, and counts the launch in ``esfk.launches`` and
  ``esfk.launches_by_route``; on a CPU tensor it runs ``esfk_plain``. There
  is no other path: on CUDA, D1 and D2 must be whole 16-byte rows (f32
  multiples of 4, bf16 of 8) and x1 and x2 16-byte aligned, or it raises.
  An expert's rows may be split over several CTAs of one output tile
  (``_plan``, from the shapes and the SM count), whose partials the last
  of them sums in a fixed order through a workspace kept per device
  (``_workspace``, which ``estmm``'s f32 route shares): calls that share
  it must not overlap, so launch them on one stream.
* ``esfk_plain`` — the plain PyTorch version: ``estmm_plain`` for dW and
  ``ess_plain`` for db (the JAX package's unfused pair).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ess import ess_plain
from repro_torch.kernels.estmm import _check_cuda_args, estmm_plain

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_ROUTES = {"mma_tf32x3": 1, "mma_bf16": 2}
_VP, _I = ctypes.c_void_p, ctypes.c_int
_ARGTYPES = [_VP] * 7 + [_I] * 7 + [_VP]
#: csrc/esfk.cu's tensor-core tile (128 x 128 of dW), two CTAs an SM.
_TILE, _CTAS_PER_SM = 128, 2
#: _plan: CTAs worth this many waves of the card, and rows a split at least
_WAVES, _MIN_ROWS = 6, 512
_WORKSPACE = {}


def _route(dtype) -> str:
    """``"mma_tf32x3"`` for f32 and ``"mma_bf16"`` for bf16."""
    return "mma_tf32x3" if dtype == torch.float32 else "mma_bf16"


def _plan(np_rows: int, d1: int, d2: int, e: int, sms: int) -> int:
    """CTAs that share an expert's rows (splits): enough for the tiles
    times the splits to make ``_WAVES`` waves of the card's ``2 * sms``
    CTA slots, but no more than leaves ``_MIN_ROWS`` rows a split of an
    expert's mean run, and at least 1. At Swin-MoE-Small's stage 2 on an
    H100 (288 tiles, ~3,260 rows an expert) that is 6; at stage 3 (1,152
    tiles, ~910 rows) 1, the fastest of the counts timed (PERF.md)."""
    tiles = e * -(-d1 // _TILE) * -(-d2 // _TILE)
    want = -(-_WAVES * _CTAS_PER_SM * sms // tiles)
    return max(1, min(want, np_rows // (e * _MIN_ROWS)))


def _workspace(device, floats: int, tickets: int):
    """The kernel's partials (f32) and tickets (int32, zero between
    calls), from buffers kept per device that only ever grow."""
    have = _WORKSPACE.get(device.index)
    if have is None or have[0].numel() < floats or have[1].numel() < tickets:
        floats = max(floats, 0 if have is None else have[0].numel())
        tickets = max(tickets, 0 if have is None else have[1].numel())
        have = (torch.empty(floats, dtype=torch.float32, device=device),
                torch.zeros(tickets, dtype=torch.int32, device=device))
        _WORKSPACE[device.index] = have
    return have


def _split_workspace(device, d1: int, d2: int, e: int, splits: int,
                     with_db: bool = True):
    """(partials, tickets) pointers for a launch with ``splits`` CTAs an
    expert's rows, as ``csrc/esfk.cu`` lays them out (dW partials, then
    db's when ``with_db``); (None, None) for one split."""
    if splits == 1:
        return None, None
    tiles = -(-d1 // _TILE) * -(-d2 // _TILE) * e
    floats = tiles * splits * _TILE * _TILE
    if with_db:
        floats += e * -(-d2 // _TILE) * splits * _TILE
    return tuple(t.data_ptr() for t in _workspace(device, floats, tiles))


def esfk_plain(x1, x2, block_expert, counts):
    """Plain PyTorch ESFK: (Np, D1), (Np, D2) -> ((E, D1, D2), (E, D2)) f32."""
    return (estmm_plain(x1, x2, block_expert, counts),
            ess_plain(x2, block_expert, counts))


def _launch(x1, x2, counts, route: str, splits: int):
    """One launch on ``route`` with ``splits`` CTAs an expert's rows.
    Operands already checked."""
    np_rows, d1 = x1.shape
    d2, e = x2.shape[1], counts.shape[0]
    dw = torch.empty((e, d1, d2), dtype=torch.float32, device=x1.device)
    db = torch.empty((e, d2), dtype=torch.float32, device=x1.device)
    parts, tickets = _split_workspace(x1.device, d1, d2, e, splits)
    launch = build.load("esfk", "esfk_launch", _ARGTYPES)
    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = launch(x1.data_ptr(), x2.data_ptr(), counts.data_ptr(),
                     dw.data_ptr(), db.data_ptr(), parts, tickets, np_rows,
                     d1, d2, e, _DTYPES[x1.dtype], _ROUTES[route], splits,
                     stream)
    if err:
        raise RuntimeError(f"esfk kernel launch failed on the {route} route "
                           f"(CUDA error {err})")
    return dw, db


def _check_args(x1, x2, block_expert, counts):
    """``estmm``'s operand checks, then rows of whole 16-byte copies and
    16-byte aligned x1 and x2. Returns (Np, D1, D2, E, route)."""
    np_rows, d1, d2, e = _check_cuda_args(x1, x2, block_expert, counts,
                                          "esfk")
    route = _route(x1.dtype)
    per16 = 16 // x1.element_size()
    if d1 % per16 or d2 % per16:
        raise ValueError(f"esfk's kernel copies rows in 16-byte pieces: D1 "
                         f"{d1} and D2 {d2} must be multiples of {per16} "
                         f"in {x1.dtype}")
    if x1.data_ptr() % 16 or x2.data_ptr() % 16:
        raise ValueError(f"esfk's {route} route loads x1 and x2 in 16-byte "
                         f"copies, which need 16-byte aligned base "
                         f"addresses")
    return np_rows, d1, d2, e, route


def esfk(x1, x2, block_expert, counts):
    """(Np, D1), (Np, D2) sorted rows -> (dW (E, D1, D2), db (E, D2)), f32.

    ``counts`` (E,) int32 are the layout's ``padded_counts``: the kernel
    reads each expert's run of rows from them, and an expert whose entry
    is 0 gets exactly 0. ``block_expert`` gives the block size and, for
    the plain version, each block's expert. On CUDA the operands are
    checked as ``estmm``'s are, and D1 and D2 must be whole 16-byte rows
    and x1 and x2 start on 16-byte boundaries."""
    if x1.device.type == "cpu":
        return esfk_plain(x1, x2, block_expert, counts)
    if x1.device.type != "cuda":
        raise ValueError(f"esfk runs on CUDA or CPU, not {x1.device}")
    np_rows, d1, d2, e, route = _check_args(x1, x2, block_expert, counts)
    sms = torch.cuda.get_device_properties(x1.device).multi_processor_count
    out = _launch(x1, x2, counts, route, _plan(np_rows, d1, d2, e, sms))
    esfk.launches += 1
    esfk.launches_by_route[route] += 1
    return out


esfk.launches = 0
esfk.launches_by_route = dict.fromkeys(_ROUTES, 0)
