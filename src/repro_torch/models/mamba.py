"""Mamba-1 selective-SSM layer (counterpart of ``repro.models.mamba``), the
recurrent mixer of the Jamba hybrid.

Prefill and training run the chunked selective scan: within a chunk of
``cfg.mamba.chunk`` tokens the recurrence ``h_t = a_t * h_{t-1} + b_t``
is a log-depth inclusive scan over ``(B, C, Din, Dst)`` tensors (the
combine of JAX's ``associative_scan``), and the chunks are chained in
order with a ``(B, Din, Dst)`` carry, so no ``(B, S, Din, Dst)`` tensor
exists at full prompt length; in training each chunk is recomputed in
the backward. Decode is the O(1) update of that state. Plain PyTorch, as
the JAX layer is plain ``jnp``. On a mesh the layer is an island that
splits its inner channels over "tp" (``_apply_mamba_mesh``).
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.parallel.moe_parallel import _Gather, _Psum
from repro_torch.parallel.sharding import as_axes, normal_init, physical_spec


def _dims(cfg: ModelConfig):
    m = cfg.mamba
    d_in = m.expand * cfg.d_model
    dt_rank = m.dt_rank or -(-cfg.d_model // 16)
    return d_in, m.d_state, m.d_conv, dt_rank


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``log(1 + exp(x))`` at every x, as ``jax.nn.softplus`` computes it
    (``F.softplus`` returns x itself above its threshold of 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def causal_depthwise_conv(x: torch.Tensor, w: torch.Tensor,
                          b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal 1-D conv. x: (B, S, D); w: (K, D); b: (D,) f32.
    The K taps accumulate in f32 and round once to x's dtype, as XLA's
    convolution does; the bias adds in f32. Returns f32."""
    k = w.shape[0]
    s = x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0)).float()
    wf = w.to(x.dtype).float()
    acc = xp[:, 0:s] * wf[0]
    for j in range(1, k):
        acc = acc + xp[:, j:j + s] * wf[j]
    return acc.to(x.dtype).float() + b


def init_mamba(cfg: ModelConfig, dtype, generator, device) -> dict:
    """S4D-real ``a_log``, ``dt_bias`` the inverse softplus of a log-uniform
    dt in [1e-3, 1e-1], a 0.2-std conv and 0.02-std projections."""
    d = cfg.d_model
    d_in, d_state, d_conv, dt_rank = _dims(cfg)
    p = {
        "in_proj": normal_init((d, 2 * d_in), dtype, generator, device),
        "conv_w": normal_init((d_conv, d_in), dtype, generator, device, 0.2),
        "conv_b": torch.zeros(d_in, dtype=torch.float32, device=device),
        "x_proj": normal_init((d_in, dt_rank + 2 * d_state), dtype,
                              generator, device),
        "dt_proj": normal_init((dt_rank, d_in), dtype, generator, device),
    }
    u = torch.rand(d_in, dtype=torch.float32, device=device,
                   generator=generator)
    dt = torch.exp(u * (math.log(0.1) - math.log(0.001)) + math.log(0.001))
    a = torch.arange(1, d_state + 1, dtype=torch.float32,
                     device=device).expand(d_in, d_state)
    p.update({
        "dt_bias": dt + torch.log(-torch.expm1(-dt)),
        "a_log": torch.log(a).contiguous(),
        "d_skip": torch.ones(d_in, dtype=torch.float32, device=device),
        "out_proj": normal_init((d_in, d), dtype, generator, device),
    })
    return p


def _chunk_len(chunk: int, s: int) -> int:
    chunk = min(chunk, s)
    while s % chunk:
        chunk //= 2
    return chunk


def _inclusive_scan(log_a: torch.Tensor, bu: torch.Tensor):
    """Inclusive scan of ``h_t = exp(log_a_t) h_{t-1} + bu_t`` over axis 1
    from h = 0, by doubling (Hillis-Steele): log2(C) rounds of JAX's
    combine ``(la, lb), (ra, rb) -> (la + ra, exp(ra) lb + rb)``. Returns
    (sum of log_a up to t, h_t from a zero start)."""
    c = log_a.shape[1]
    d = 1
    while d < c:
        new_b = bu.clone()
        new_b[:, d:] = torch.exp(log_a[:, d:]) * bu[:, :-d] + bu[:, d:]
        new_a = log_a.clone()
        new_a[:, d:] = log_a[:, d:] + log_a[:, :-d]
        log_a, bu = new_a, new_b
        d *= 2
    return log_a, bu


def _ssm_chunk(h, u_c, dt_c, b_c, c_c, a):
    """One chunk of the selective scan from the carry ``h`` (B, Din, Dst):
    the discretisation, the in-chunk scan and the readout. Returns (the
    chunk's last state, y (B, C, Din) f32)."""
    dt_f = dt_c.float()
    log_a = dt_f[..., None] * a[None, None]                   # (B,C,Din,Dst)
    bu = (dt_f * u_c.float())[..., None] * b_c.float()[:, :, None, :]
    acc_a, acc_b = _inclusive_scan(log_a, bu)
    h_t = acc_b + torch.exp(acc_a) * h[:, None]
    return h_t[:, -1], torch.einsum("bcds,bcs->bcd", h_t, c_c.float())


def _ssm_chunked(u, dt, b_in, c_in, a, chunk: int, remat: bool = False):
    """Selective scan. u: (B, S, Din) model dtype; dt: (B, S, Din) f32;
    b_in/c_in: (B, S, Dst); a: (Din, Dst) f32. Returns y (B, S, Din) f32
    and the final state (B, Din, Dst), the last position's. The
    discretisation ``(B, C, Din, Dst)`` exists one chunk at a time.
    ``remat`` (training) checkpoints each chunk, as the JAX scan's
    ``jax.checkpoint`` of its step does: autograd keeps only the chunk's
    inputs and its carry, and the chunk's scan runs again in the
    backward, so the doubling scan's ``(B, C, Din, Dst)`` rounds are held
    for one chunk at a time."""
    bsz, s, d_in = u.shape
    chunk = _chunk_len(chunk, s)
    h = torch.zeros((bsz, d_in, a.shape[1]), dtype=torch.float32,
                    device=u.device)
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        args = (h, u[:, sl], dt[:, sl], b_in[:, sl], c_in[:, sl], a)
        if remat:
            h, y = checkpoint(_ssm_chunk, *args, use_reentrant=False)
        else:
            h, y = _ssm_chunk(*args)
        ys.append(y)
    return torch.cat(ys, dim=1), h


#: Logical specs of the layer's leaves (the JAX package's ``Param``
#: tags): channels (``d_inner``) over "tp".
MAMBA_LOGICAL = {"in_proj": ("fsdp", "tp"), "conv_w": (None, "tp"),
                 "conv_b": ("tp",), "x_proj": ("tp", None),
                 "dt_proj": (None, "tp"), "dt_bias": ("tp",),
                 "a_log": ("tp", None), "d_skip": ("tp",),
                 "out_proj": ("tp", "fsdp")}


def param_shapes(cfg: ModelConfig) -> dict:
    """Global shapes of the layer's leaves."""
    d = cfg.d_model
    d_in, d_state, d_conv, dt_rank = _dims(cfg)
    return {"in_proj": (d, 2 * d_in), "conv_w": (d_conv, d_in),
            "conv_b": (d_in,), "x_proj": (d_in, dt_rank + 2 * d_state),
            "dt_proj": (dt_rank, d_in), "dt_bias": (d_in,),
            "a_log": (d_in, d_state), "d_skip": (d_in,),
            "out_proj": (d_in, d)}


def apply_mamba(p: dict, x: torch.Tensor, ctx, cache: Optional[dict]):
    """x: (B, S, D) -> (y, new_cache). ``cache``: {"conv": (B, K-1, Din)
    in the model dtype, "ssm": (B, Din, Dst) f32}; decode (S == 1) reads
    and advances it, prefill/train start from zero and, with a cache,
    return the final state (conv: the last K-1 pre-conv inputs). On a
    mesh: ``_apply_mamba_mesh``."""
    if ctx.mesh is not None:
        return _apply_mamba_mesh(p, x, ctx, cache)
    d_in = _dims(ctx.cfg)[0]
    xz = x @ p["in_proj"]
    y, new_cache = _mixer(p, xz[..., :d_in], xz[..., d_in:], ctx, cache,
                          x.dtype)
    return y @ p["out_proj"], new_cache


def _mixer(p: dict, xm, z, ctx, cache, dtype, proj_sum=None):
    """The layer between its two projections, over the channels of
    ``xm``/``z`` (B, S, C) and the leaves' matching blocks: the causal
    conv (or its decode window), ``x_proj`` (its partial sums completed
    by ``proj_sum`` where the channels are a block), the discretisation,
    the scan (or the decode update) and the gate. Returns (y (B, S, C)
    in ``dtype``, new_cache)."""
    mode = ctx.mode
    _, d_state, d_conv, dt_rank = _dims(ctx.cfg)
    if mode == "decode":
        assert xm.shape[1] == 1 and cache is not None
        conv_state = torch.cat([cache["conv"], xm.to(cache["conv"].dtype)],
                               dim=1)                         # (B, K, Din)
        xm_c = torch.einsum("bkd,kd->bd", conv_state.float(),
                            p["conv_w"].float()) + p["conv_b"]
        xm = F.silu(xm_c)[:, None].to(dtype)
        new_conv = conv_state[:, 1:]
    else:
        xm_conv = causal_depthwise_conv(xm, p["conv_w"], p["conv_b"])
        new_conv = None
        if cache is not None:
            new_conv = F.pad(xm, (0, 0, d_conv - 1, 0))[:, -(d_conv - 1):]
            new_conv = new_conv.to(cache["conv"].dtype)
        xm = F.silu(xm_conv).to(dtype)

    proj = xm @ p["x_proj"]
    if proj_sum is not None:
        proj = proj_sum(proj)
    dt_lr = proj[..., :dt_rank]
    b_in = proj[..., dt_rank:dt_rank + d_state]
    c_in = proj[..., dt_rank + d_state:]
    dt = softplus(dt_lr.float() @ p["dt_proj"].float() + p["dt_bias"])
    a = -torch.exp(p["a_log"])                                # (Din, Dst)

    if mode == "decode":
        h = cache["ssm"]
        da = torch.exp(dt[:, 0, :, None] * a[None])           # (B,Din,Dst)
        h = da * h + (dt[:, 0] * xm[:, 0].float())[..., None] * \
            b_in[:, 0].float()[:, None, :]
        y = torch.einsum("bds,bs->bd", h, c_in[:, 0].float())[:, None]
        new_ssm = h
    else:
        y, new_ssm = _ssm_chunked(xm, dt, b_in, c_in, a, ctx.cfg.mamba.chunk,
                                  remat=mode == "train")

    y = y + p["d_skip"] * xm.float()
    y = (y * F.silu(z.float())).to(dtype)
    if cache is None:
        return y, None
    return y, {"conv": new_conv, "ssm": new_ssm}


def _apply_mamba_mesh(p: dict, x: torch.Tensor, ctx, cache):
    """The layer as an island on a mesh, x at ``ctx.x_spec``. Where "tp"
    splits ``d_inner``: the sequence gathered over "sp" once,
    ``in_proj`` column-parallel (the products gathered over the channels,
    each rank keeping its block of ``xm`` and of ``z``), the conv,
    ``dt_proj`` and the scan on this rank's channels, ``x_proj``
    row-parallel with its partial sums all-reduced (its output is
    replicated, as the JAX package constrains it), ``out_proj``
    row-parallel, reduce-scattered back over the sequence. The decode
    state is this rank's channels. Where it does not split: the weights
    gathered whole, the layer on the whole sequence, and this rank's
    sequence block kept."""
    from repro_torch.models import transformer as tfm

    mesh = ctx.mesh
    d_in = _dims(ctx.cfg)[0]
    tp = as_axes(ctx.pcfg.axes(mesh)["tp"])
    split = mesh_split(ctx.cfg, ctx.pcfg, mesh)
    w, _ = tfm.mesh_weights(p, ctx, param_shapes(ctx.cfg), MAMBA_LOGICAL,
                            gather_tp=not split)
    seq_axes = as_axes(ctx.x_spec[1])
    x = tfm.seq_gather(tfm.island_in(x, mesh, ctx.x_spec), mesh, seq_axes)
    xz = x @ w["in_proj"]
    if not split:
        y, new_cache = _mixer(w, xz[..., :d_in], xz[..., d_in:], ctx, cache,
                              x.dtype)
        out = tfm.seq_take(y @ w["out_proj"], mesh, seq_axes)
        return tfm.island_out(out, mesh, ctx.x_spec), new_cache
    xz = _Gather.apply(xz, mesh, tp, 2)
    dl = d_in // mesh.size(tp)
    r = mesh.index(tp)
    xm = xz[..., r * dl:(r + 1) * dl]
    z = xz[..., d_in + r * dl:d_in + (r + 1) * dl]
    y, new_cache = _mixer(w, xm, z, ctx, cache, x.dtype,
                          proj_sum=lambda t: _Psum.apply(t, mesh, tp))
    out = tfm.tp_reduce(y @ w["out_proj"], mesh, seq_axes, tp)
    return tfm.island_out(out, mesh, ctx.x_spec), new_cache


def mesh_split(cfg: ModelConfig, pcfg, mesh) -> bool:
    """Whether the layer splits ``d_inner`` over "tp" on ``mesh`` (its
    decode state then holds this rank's channels)."""
    tp = as_axes(pcfg.axes(mesh)["tp"])
    if cfg.mamba is None or not tp:
        return False
    shapes = param_shapes(cfg)
    return all(
        as_axes(physical_spec(shapes[k], MAMBA_LOGICAL[k], pcfg, mesh)[i])
        == tp for k, i in (("in_proj", 1), ("conv_w", 1), ("x_proj", 0),
                           ("dt_proj", 1), ("a_log", 0), ("out_proj", 0)))


def cache_spec_mamba(cfg: ModelConfig, batch: int, dtype) -> dict:
    """Per-slot state shapes and dtypes: the conv window in the model
    dtype, the SSM state in f32."""
    d_in, d_state, d_conv, _ = _dims(cfg)
    return {"conv": ((batch, d_conv - 1, d_in), dtype),
            "ssm": ((batch, d_in, d_state), torch.float32)}
