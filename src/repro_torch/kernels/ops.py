"""Public expert-specific ops with their backward (counterpart of
``repro.kernels.ops``).

The implementation follows the tensor's device: the hand-written kernel
for a CUDA tensor, its plain version for a CPU tensor (each kernel
wrapper decides). The backward is wired as the paper's Table 5, as the
JAX package's ``custom_vjp``s wire it:

* ``esmm`` — differentiable ESMM: dX by ESMM with the other weight
  orientation, (dW, db) by ``_esfk_any`` (``_esmm_fwd``/``_esmm_bwd``).
* ``esffn_glu`` / ``esffn_mlp`` — the fused expert FFNs: the forward is
  the fused kernel; the backward is flash-style (``_esffn_glu_bwd``,
  ``_esffn_mlp_bwd``): only xs-level residuals are saved, the hidden is
  recomputed by ESMM, and the grads flow through ESMM (recompute, ``t =
  dys_w W_down^T``, dX) and ``_esfk_any`` (dW, and db where the expert has
  biases), with a gradient for ``row_gate``.

``_esfk_any`` computes (dW, db) with the fused ESFK kernel when a bias
needs its db and the backward is fused (the default), else with ESTMM and,
for db, ESS: ``set_fused_backward(False)`` is the paper's Fig. 12
"fused kernel" ablation. Bias-free experts (GLU) always take ESTMM.
"""
from __future__ import annotations

import torch

from repro_torch.common import ACTIVATIONS, QUANT_NOT_PORTED
from repro_torch.core.reindex import gather_rows
from repro_torch.kernels import esffn as esffn_kernel
from repro_torch.kernels import esfk as esfk_kernel
from repro_torch.kernels import esmm as esmm_kernel
from repro_torch.kernels import ess as ess_kernel
from repro_torch.kernels import estmm as estmm_kernel

_FUSED_BACKWARD = True


def set_fused_backward(fused: bool) -> None:
    """Toggle the ESFK fusion (paper Fig. 12 "fused kernel" ablation):
    with False, (dW, db) take ESTMM and ESS."""
    global _FUSED_BACKWARD
    _FUSED_BACKWARD = fused


def _esmm_any(transpose_rhs, xs, w, b, block_expert, w_scales=None):
    return esmm_kernel.esmm(xs.contiguous(), w, b, block_expert,
                            w_scales=w_scales, transpose_rhs=transpose_rhs)


def _esfk_any(x1, x2, block_expert, padded_counts, need_db):
    """(dW, db) with db=None when need_db is False: ESFK in one pass when
    the backward is fused and db is needed, else ESTMM (+ ESS for db)."""
    x1, x2 = x1.contiguous(), x2.contiguous()
    if _FUSED_BACKWARD and need_db:
        return esfk_kernel.esfk(x1, x2, block_expert, padded_counts)
    dw = estmm_kernel.estmm(x1, x2, block_expert, padded_counts)
    db = (ess_kernel.ess(x2, block_expert, padded_counts) if need_db
          else None)
    return dw, db


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
        if t and ctx.has_b and need_b:
            # ESFK sums x2 = xs here, not dy; the JAX op refuses it too
            # (its bwd rule's db has the wrong shape).
            raise NotImplementedError(
                "the bias grad of a transposed ESMM is not defined")
        if need_w or need_b:
            # dW (ESTMM) + db (ESS), fused as ESFK (paper rows 4/5/8/9).
            x1, x2 = (dy, xs) if t else (xs, dy)
            dw, db = _esfk_any(x1, x2, block_expert, padded_counts,
                               ctx.has_b and need_b)
            dw = dw.to(w.dtype)
            if db is not None:
                db = db.to(dy.dtype)    # JAX: db.astype(dy.dtype)
        return dxs, dw, db, None, None, None


def esmm(xs, w, b, block_expert, padded_counts, *, w_scales=None,
         transpose_rhs: bool = False) -> torch.Tensor:
    """Differentiable expert-specific matmul on the sorted layout.

    xs: (Np, K); w: (E, K, N), or (E, N, K) with transpose_rhs; b: (E, N)
    or None; block_expert/padded_counts from ``core.reindex.build_reindex``."""
    if w_scales is not None:
        raise NotImplementedError(QUANT_NOT_PORTED)
    return _ESMM.apply(xs, w, b, block_expert, padded_counts, transpose_rhs)


#: Non-differentiable ESTMM: (Np, D1), (Np, D2) -> (E, D1, D2) f32.
estmm = estmm_kernel.estmm


def esfk(x1, x2, block_expert, padded_counts):
    """(dW, db) of the sorted rows: ESFK, or ESTMM + ESS when the backward
    is not fused. Non-differentiable."""
    return _esfk_any(x1, x2, block_expert, padded_counts, True)


#: Non-differentiable ESS: (Np, D) -> (E, D) f32 per-expert sums.
ess = ess_kernel.ess


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
        raise NotImplementedError(QUANT_NOT_PORTED)
    return _ESFFNGLU.apply(x, row_token, row_gate, block_expert,
                           padded_counts, w_gate, w_up, w_down, act)


class _ESFFNMLP(torch.autograd.Function):
    """Fused 2-MLP expert FFN with the flash-style recompute backward."""

    @staticmethod
    def forward(ctx, x, row_token, row_gate, block_expert, padded_counts,
                w1, b1, w2, b2, act):
        ctx.act = act
        ctx.has_b = (b1 is not None, b2 is not None)
        # xs-level residuals only: no (Np, F) hidden is saved.
        ctx.save_for_backward(x, row_token, row_gate, block_expert,
                              padded_counts, w1, b1, w2, b2)
        return esffn_kernel.esffn_mlp(x, row_token, row_gate, block_expert,
                                      w1, b1, w2, b2, act=act)

    @staticmethod
    def backward(ctx, dys_w):
        x, row_token, row_gate, be, pc, w1, b1, w2, b2 = ctx.saved_tensors
        has_b1, has_b2 = ctx.has_b
        dys_w = dys_w.contiguous()
        # Recompute z (with b1) from the xs-level residuals.
        xs = gather_rows(x, row_token)
        z = _esmm_any(False, xs, w1, b1, be)
        with torch.enable_grad():
            z_ = z.detach().requires_grad_()
            h = ACTIVATIONS[ctx.act](z_)
        # d_gate[r] = dys_w[r] . ys[r] with ys = h W2 + b2, split so ys is
        # never rebuilt: the h W2 term contracts t = dys_w W2^T against h,
        # the b2 term is direct.
        t = _esmm_any(True, dys_w, w2, None, be)
        d_gate = torch.sum(t.float() * h.detach().float(), dim=-1)
        if has_b2:
            blk = xs.shape[0] // be.shape[0]
            b2_rows = b2[be.long().repeat_interleave(blk)]
            d_gate = d_gate + torch.sum(dys_w.float() * b2_rows.float(),
                                        dim=-1)
        gate = row_gate[:, None].to(dys_w.dtype)
        dys = dys_w * gate
        (dz,) = torch.autograd.grad(h, z_, (t * gate).to(h.dtype))
        h = h.detach()
        dw2, db2 = _esfk_any(h, dys, be, pc, has_b2)
        dw1, db1 = _esfk_any(xs, dz, be, pc, has_b1)
        dxs = _esmm_any(True, dz, w1, None, be)
        return (_scatter_dx(x, row_token, dxs), None,
                d_gate.to(row_gate.dtype), None, None,
                dw1.to(w1.dtype), db1.to(b1.dtype) if has_b1 else None,
                dw2.to(w2.dtype), db2.to(b2.dtype) if has_b2 else None, None)


def esffn_mlp(x, row_token, row_gate, block_expert, padded_counts, w1, b1,
              w2, b2, *, scales=None, act: str = "gelu") -> torch.Tensor:
    """Fused 2-MLP expert FFN ``(act(x W1 + b1) W2 + b2) * gate`` over the
    sorted layout, differentiable in x, row_gate, the weights and the
    biases (either bias may be None).

    x: (N, D) UNSORTED tokens; w1 (E, D, F), b1 (E, F), w2 (E, F, D), b2
    (E, D); row maps from ``core.reindex.build_reindex``. Returns the
    gate-weighted sorted output (Np, D) — combine it with
    ``core.reindex.scatter_rows``. The backward's (dW, db) pairs take ESFK
    (``set_fused_backward(False)``: ESTMM + ESS)."""
    if scales is not None:
        raise NotImplementedError(QUANT_NOT_PORTED)
    return _ESFFNMLP.apply(x, row_token, row_gate, block_expert,
                           padded_counts, w1, b1, w2, b2, act)
