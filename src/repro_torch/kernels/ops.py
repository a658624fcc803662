"""Public expert-specific ops with their backward (counterpart of
``repro.kernels.ops``).

The implementation follows the tensor's device: the hand-written kernel
for a CUDA tensor, its plain version for a CPU tensor (each kernel
wrapper decides). The backward is wired as the paper's Table 5, as the
JAX package's ``custom_vjp``s wire it:

* ``esmm`` — differentiable ESMM: dX by ESMM with the other weight
  orientation, dW by ESTMM (``_esmm_fwd``/``_esmm_bwd``).
* ``esffn_glu`` — the fused GLU expert FFN: the forward is the fused
  kernel; the backward is flash-style (``_esffn_glu_bwd``): only xs-level
  residuals are saved, the hidden is recomputed by ESMM, and the grads
  flow through ESMM (g, u, ``t = dys_w Wd^T``, dX) and ESTMM (dWg, dWu,
  dWd), with a gradient for ``row_gate``.

GLU experts have no biases, so ``db`` is never needed on this path; the
fused ESFK kernel (dW and db in one pass) and ESS (db alone) belong to the
MLP-expert slice and raise here.
"""
from __future__ import annotations

import torch

from repro_torch.common import ACTIVATIONS
from repro_torch.core.reindex import gather_rows
from repro_torch.kernels import esffn as esffn_kernel
from repro_torch.kernels import esmm as esmm_kernel
from repro_torch.kernels import estmm as estmm_kernel

_MLP_SLICE = ("expert biases (ESFK / ESS: dW with db) are not ported yet "
              "(ROADMAP.md: the MLP-expert slice, with esffn_mlp)")


def _esmm_any(transpose_rhs, xs, w, b, block_expert, w_scales=None):
    return esmm_kernel.esmm(xs.contiguous(), w, b, block_expert,
                            w_scales=w_scales, transpose_rhs=transpose_rhs)


def _esfk_any(x1, x2, block_expert, padded_counts, need_db):
    """(dW, db) with db=None when need_db is False: ESTMM alone."""
    if need_db:
        raise NotImplementedError(_MLP_SLICE)
    return estmm_kernel.estmm(x1.contiguous(), x2.contiguous(), block_expert,
                              padded_counts), None


class _ESMM(torch.autograd.Function):
    """Differentiable ESMM (paper Table 5 rows 4-10)."""

    @staticmethod
    def forward(ctx, xs, w, b, block_expert, padded_counts, transpose_rhs):
        ctx.transpose_rhs = transpose_rhs
        ctx.has_b = b is not None
        ctx.save_for_backward(xs, w, block_expert, padded_counts)
        return _esmm_any(transpose_rhs, xs, w, b, block_expert)

    @staticmethod
    def backward(ctx, dy):
        xs, w, block_expert, padded_counts = ctx.saved_tensors
        t = ctx.transpose_rhs
        need_x, need_w, need_b = ctx.needs_input_grad[:3]
        dxs = dw = db = None
        if need_x:
            # dX: ESMM with the opposite weight orientation.
            dxs = _esmm_any(not t, dy, w, None, block_expert)
        if need_w or need_b:
            # dW by ESTMM (db, where a bias needs one, by ESFK).
            x1, x2 = (dy, xs) if t else (xs, dy)
            dw, db = _esfk_any(x1, x2, block_expert, padded_counts,
                               ctx.has_b and need_b)
            dw = dw.to(w.dtype)
        return dxs, dw, db, None, None, None


def esmm(xs, w, b, block_expert, padded_counts, *, w_scales=None,
         transpose_rhs: bool = False) -> torch.Tensor:
    """Differentiable expert-specific matmul on the sorted layout.

    xs: (Np, K); w: (E, K, N), or (E, N, K) with transpose_rhs; b: (E, N)
    or None; block_expert/padded_counts from ``core.reindex.build_reindex``.
    A bias runs forward; its backward (db) raises (the MLP-expert slice)."""
    if w_scales is not None:
        raise NotImplementedError(
            "quantized expert weights (w_scales) are not ported yet "
            "(ROADMAP.md: quantization slice)")
    return _ESMM.apply(xs, w, b, block_expert, padded_counts, transpose_rhs)


#: Non-differentiable ESTMM: (Np, D1), (Np, D2) -> (E, D1, D2) f32.
estmm = estmm_kernel.estmm


def esfk(x1, x2, block_expert, padded_counts):
    """(dW, db): needs ``db``, so it belongs to the MLP-expert slice."""
    return _esfk_any(x1, x2, block_expert, padded_counts, True)


def ess(x, block_expert, padded_counts):
    """db[e] = sum of expert e's rows: the MLP-expert slice."""
    raise NotImplementedError(_MLP_SLICE)


def _scatter_dx(x, row_token, dxs):
    """dX: scatter-add the sorted-row grads back to token order; sentinel
    rows (== N) land in a dropped extra row."""
    out = x.new_zeros((x.shape[0] + 1, x.shape[1]))
    out.index_add_(0, row_token.long(), dxs.to(x.dtype))
    return out[:x.shape[0]]


class _ESFFNGLU(torch.autograd.Function):
    """Fused GLU expert FFN with the flash-style recompute backward."""

    @staticmethod
    def forward(ctx, x, row_token, row_gate, block_expert, padded_counts,
                wg, wu, wd, act):
        ctx.act = act
        # xs-level residuals only: no (Np, F) hidden is saved.
        ctx.save_for_backward(x, row_token, row_gate, block_expert,
                              padded_counts, wg, wu, wd)
        return esffn_kernel.esffn_glu(x, row_token, row_gate, block_expert,
                                      wg, wu, wd, act=act)

    @staticmethod
    def backward(ctx, dys_w):
        x, row_token, row_gate, be, pc, wg, wu, wd = ctx.saved_tensors
        dys_w = dys_w.contiguous()
        # Recompute the hidden from the xs-level residuals.
        xs = gather_rows(x, row_token)
        g = _esmm_any(False, xs, wg, None, be)
        u = _esmm_any(False, xs, wu, None, be)
        with torch.enable_grad():
            g_ = g.detach().requires_grad_()
            u_ = u.detach().requires_grad_()
            h = ACTIVATIONS[ctx.act](g_) * u_
        # t = dys_w @ Wd[e]^T serves both dh (scaled by the gate) and
        # d_gate (contracted against h): ys itself is never rebuilt.
        t = _esmm_any(True, dys_w, wd, None, be)
        d_gate = torch.sum(t.float() * h.detach().float(), dim=-1)
        gate = row_gate[:, None].to(dys_w.dtype)
        dys = dys_w * gate
        dg, du = torch.autograd.grad(h, (g_, u_), (t * gate).to(h.dtype))
        h = h.detach()
        dwd = _esfk_any(h, dys, be, pc, False)[0].to(wd.dtype)
        dwg = _esfk_any(xs, dg, be, pc, False)[0].to(wg.dtype)
        dwu = _esfk_any(xs, du, be, pc, False)[0].to(wu.dtype)
        dxs = (_esmm_any(True, dg, wg, None, be)
               + _esmm_any(True, du, wu, None, be))
        return (_scatter_dx(x, row_token, dxs), None,
                d_gate.to(row_gate.dtype), None, None, dwg, dwu, dwd, None)


def esffn_glu(x, row_token, row_gate, block_expert, padded_counts, w_gate,
              w_up, w_down, *, scales=None, act: str = "silu") -> torch.Tensor:
    """Fused GLU expert FFN over the sorted layout, differentiable in x,
    row_gate and the three weights.

    x: (N, D) UNSORTED tokens; row maps from ``core.reindex.build_reindex``.
    Returns the gate-weighted sorted output (Np, D) — combine it with
    ``core.reindex.scatter_rows``. ``padded_counts`` gives the backward's
    ESTMM each expert's run of rows."""
    if scales is not None:
        raise NotImplementedError(
            "quantized expert weights (w_scales) are not ported yet "
            "(ROADMAP.md: quantization slice)")
    return _ESFFNGLU.apply(x, row_token, row_gate, block_expert,
                           padded_counts, w_gate, w_up, w_down, act)
