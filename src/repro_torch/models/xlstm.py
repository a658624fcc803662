"""xLSTM layers (counterpart of ``repro.models.xlstm``): mLSTM (matrix
memory, chunkwise-parallel) and sLSTM (scalar memory, sequential), the
mixers of xlstm-350m.

mLSTM prefills with the chunkwise form: inside a chunk the exponential
gating is an attention-like ``(C, C)`` matrix per head, stabilised by a
running max ``m``; across chunks a ``(hd, hd)`` matrix memory is carried.
Decode is the O(hd^2) recurrent update. sLSTM has a true sequential
dependency through its block-diagonal recurrent matrix, so it is a loop
over time in both modes; the loop emits each step's ``h`` rounded to
bf16, whatever the model's dtype, as the JAX scan does. In training
every mLSTM chunk and every sLSTM step is recomputed in the backward
(``torch.utils.checkpoint``), as the JAX scans checkpoint their steps.
Plain PyTorch. On a mesh each layer is an island whose cell runs
replicated over "tp", as the JAX package constrains it: the recurrent
head structure is too narrow to split.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models.mamba import _chunk_len, causal_depthwise_conv
from repro_torch.parallel.moe_parallel import _Gather
from repro_torch.parallel.sharding import as_axes, normal_init

NEG = -1e30

#: Logical specs of the leaves (the JAX package's ``Param`` tags).
MLSTM_LOGICAL = {"up": ("fsdp", "tp"), "conv_w": (None, "tp"),
                 "conv_b": ("tp",), "wq": ("tp", None), "wk": ("tp", None),
                 "wv": ("tp", None), "w_if": ("tp", None), "b_if": (None,),
                 "down": ("tp", "fsdp")}
SLSTM_LOGICAL = {"w_in": ("fsdp", "tp"), "r": (None, None, None),
                 "b": (None,)}


def _dims(cfg: ModelConfig):
    d_in = int(cfg.xlstm.proj_factor * cfg.d_model)
    nh = cfg.num_heads
    return d_in, nh, d_in // nh


def mlstm_shapes(cfg: ModelConfig) -> dict:
    """Global shapes of an mLSTM layer's leaves."""
    d = cfg.d_model
    d_in, nh, _ = _dims(cfg)
    return {"up": (d, 2 * d_in), "conv_w": (cfg.xlstm.conv_kernel, d_in),
            "conv_b": (d_in,), "wq": (d_in, d_in), "wk": (d_in, d_in),
            "wv": (d_in, d_in), "w_if": (d_in, 2 * nh), "b_if": (2 * nh,),
            "down": (d_in, d)}


def slstm_shapes(cfg: ModelConfig) -> dict:
    """Global shapes of an sLSTM layer's leaves."""
    d, nh = cfg.d_model, cfg.num_heads
    return {"w_in": (d, 4 * d), "r": (nh, d // nh, 4 * d // nh),
            "b": (4 * d,)}


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def init_mlstm(cfg: ModelConfig, dtype, generator, device) -> dict:
    d = cfg.d_model
    d_in, nh, _ = _dims(cfg)
    kconv = cfg.xlstm.conv_kernel
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "up": normal_init((d, 2 * d_in), dtype, generator, device),
        "conv_w": normal_init((kconv, d_in), dtype, generator, device, 0.2),
        "conv_b": torch.zeros(d_in, **f32),
        "wq": normal_init((d_in, d_in), dtype, generator, device),
        "wk": normal_init((d_in, d_in), dtype, generator, device),
        "wv": normal_init((d_in, d_in), dtype, generator, device),
        "w_if": normal_init((d_in, 2 * nh), dtype, generator, device),
        "b_if": torch.cat([torch.zeros(nh, **f32),
                           3.0 * torch.ones(nh, **f32)]),
        "down": normal_init((d_in, d), dtype, generator, device),
    }


def _mlstm_chunk(c_mat, n_vec, m_run, qc, kc, vc, li, fc, tri):
    """One chunk of the chunkwise mLSTM from the carry (C (B, NH, HD, HD),
    n (B, NH, HD), m (B, NH)). q/k/v (B, C, NH, HD) any dtype, li and the
    in-chunk cumulative log forget gates fc (B, C, NH) f32. Returns the
    chunk-end carry and y (B, C, NH, HD) in v's dtype."""
    hd = qc.shape[-1]
    out_dtype = vc.dtype
    qc = qc.float()
    kc = kc.float() / (hd ** 0.5)
    vc = vc.float()
    ft = fc[:, -1]                                           # (B, NH)
    # intra-chunk pair log-weights D[t,s] = fcum_t - fcum_s + i_s, s<=t
    dmat = fc[:, :, None, :] - fc[:, None, :, :] + li[:, None, :, :]
    dmat = torch.where(tri[None, :, :, None], dmat,
                       torch.tensor(NEG, device=dmat.device))  # (B,C,C,NH)
    inter_log = fc + m_run[:, None, :]                       # (B,C,NH)
    m_t = torch.maximum(dmat.amax(dim=2), inter_log)         # (B,C,NH)
    w_pair = torch.exp(dmat - m_t[:, :, None, :])
    w_inter = torch.exp(inter_log - m_t)
    logits = torch.einsum("bthd,bshd->btsh", qc, kc)
    num = (torch.einsum("btsh,bshd->bthd", logits * w_pair, vc)
           + torch.einsum("bthd,bhde->bthe", qc, c_mat) * w_inter[..., None])
    n_t = (torch.einsum("btsh,bshd->bthd", w_pair, kc)
           + w_inter[..., None] * n_vec[:, None])
    den = torch.maximum(
        torch.einsum("bthd,bthd->bth", qc, n_t).abs(), torch.exp(-m_t))
    y = (num / den[..., None]).to(out_dtype)
    # chunk-end state
    end_log = ft[:, None, :] - fc + li                       # (B,C,NH)
    m_end = torch.maximum(ft + m_run, end_log.amax(dim=1))
    w_end = torch.exp(end_log - m_end[:, None, :])
    decay = torch.exp(ft + m_run - m_end)                    # (B, NH)
    c_mat = decay[..., None, None] * c_mat + torch.einsum(
        "bsh,bshd,bshe->bhde", w_end, kc, vc)
    n_vec = decay[..., None] * n_vec + torch.einsum(
        "bsh,bshd->bhd", w_end, kc)
    return c_mat, n_vec, m_end, y


def _mlstm_chunked(q, k, v, log_i, log_f, chunk: int, remat: bool = False):
    """q/k/v: (B, S, NH, HD) any dtype; log_i/log_f: (B, S, NH) f32.
    Returns y (B, S, NH, HD) in v's dtype and the final (C, n, m) state.
    f32 copies of q/k/v exist one chunk at a time. ``remat`` (training)
    checkpoints each chunk, as the JAX scan's ``jax.checkpoint`` of its
    step does: the chunk runs again in the backward from its inputs and
    its carry."""
    bsz, s, nh, hd = q.shape
    chunk = _chunk_len(chunk, s)
    dev = q.device
    fcum_all = torch.cumsum(log_f.reshape(bsz, s // chunk, chunk, nh), dim=2)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=dev))
    c_mat = torch.zeros((bsz, nh, hd, hd), dtype=torch.float32, device=dev)
    n_vec = torch.zeros((bsz, nh, hd), dtype=torch.float32, device=dev)
    m_run = torch.zeros((bsz, nh), dtype=torch.float32, device=dev)
    ys = []
    for ci in range(s // chunk):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        args = (c_mat, n_vec, m_run, q[:, sl], k[:, sl], v[:, sl],
                log_i[:, sl], fcum_all[:, ci], tri)
        if remat:
            c_mat, n_vec, m_run, y = checkpoint(_mlstm_chunk, *args,
                                                use_reentrant=False)
        else:
            c_mat, n_vec, m_run, y = _mlstm_chunk(*args)
        ys.append(y)
    return torch.cat(ys, dim=1), (c_mat, n_vec, m_run)


def _mlstm_step(q, k, v, log_i, log_f, state):
    """One decode step. q/k/v: (B, NH, HD) f32; gates: (B, NH)."""
    c_mat, n_vec, m_run = state
    k = k / (q.shape[-1] ** 0.5)
    m_new = torch.maximum(log_f + m_run, log_i)
    decay = torch.exp(log_f + m_run - m_new)
    inw = torch.exp(log_i - m_new)
    c_new = decay[..., None, None] * c_mat + inw[..., None, None] * (
        k[..., :, None] * v[..., None, :])
    n_new = decay[..., None] * n_vec + inw[..., None] * k
    num = torch.einsum("bhd,bhde->bhe", q, c_new)
    den = torch.maximum(torch.einsum("bhd,bhd->bh", q, n_new).abs(),
                        torch.exp(-m_new))
    return num / den[..., None], (c_new, n_new, m_new)


def apply_mlstm(p: dict, x: torch.Tensor, ctx, cache: Optional[dict]):
    """x: (B, S, D) -> (y, cache'). cache: {"c", "n", "m", "conv"}. On a
    mesh, an island: ``up`` column-parallel and its products gathered
    over the channels (the JAX package constrains ``xz`` replicated), the
    conv and the q/k/v/gate products with their weights gathered whole,
    the cell replicated over "tp", ``down`` row-parallel."""
    d_in = _dims(ctx.cfg)[0]
    if ctx.mesh is None:
        xz = x @ p["up"]
        h, new_cache = _mlstm_body(p, xz[..., :d_in], xz[..., d_in:], ctx,
                                   cache, x.dtype)
        return h @ p["down"], new_cache
    from repro_torch.models import transformer as tfm

    mesh = ctx.mesh
    w, specs = tfm.mesh_weights(p, ctx, mlstm_shapes(ctx.cfg),
                                MLSTM_LOGICAL, gather_tp=(
                                    "conv_w", "conv_b", "wq", "wk", "wv",
                                    "w_if"))
    seq_axes = as_axes(ctx.x_spec[1])
    xf = tfm.seq_gather(tfm.island_in(x, mesh, ctx.x_spec), mesh, seq_axes)
    xz = _gather_cols(xf @ w["up"], mesh, specs["up"][1])
    h, new_cache = _mlstm_body(w, xz[..., :d_in], xz[..., d_in:], ctx, cache,
                               x.dtype)
    out = tfm.row_parallel_out(h, w["down"], as_axes(specs["down"][0]), ctx,
                               seq_axes)
    return tfm.island_out(out, mesh, ctx.x_spec), new_cache


def _gather_cols(t: torch.Tensor, mesh, entry) -> torch.Tensor:
    """A column-parallel product gathered over the weight's column axes
    (a replicated whole on every rank of them)."""
    axes = as_axes(entry)
    return _Gather.apply(t, mesh, axes, t.ndim - 1) if axes else t


def _mlstm_body(p: dict, xm, z, ctx, cache, dtype):
    """The mLSTM between its two projections: conv, q/k/v and gates, the
    chunkwise cell (or its decode step), the output gate. Returns (the
    gated hidden (B, S, d_in) in ``dtype``, cache')."""
    cfg, mode = ctx.cfg, ctx.mode
    bsz, s, _ = xm.shape
    d_in, nh, hd = _dims(cfg)
    kconv = cfg.xlstm.conv_kernel

    if mode == "decode":
        conv_in = torch.cat([cache["conv"], xm.to(cache["conv"].dtype)],
                            dim=1)
        xc = torch.einsum("bkd,kd->bd", conv_in.float(),
                          p["conv_w"].float()) + p["conv_b"]
        xc = F.silu(xc)[:, None].to(dtype)
        new_conv = conv_in[:, 1:]
    else:
        xc = F.silu(causal_depthwise_conv(xm, p["conv_w"], p["conv_b"]))
        xc = xc.to(dtype)
        new_conv = None
        if cache is not None:
            new_conv = F.pad(xm, (0, 0, kconv - 1, 0))[:, -(kconv - 1):]
            new_conv = new_conv.to(cache["conv"].dtype)

    q = (xc @ p["wq"]).reshape(bsz, s, nh, hd)
    k = (xc @ p["wk"]).reshape(bsz, s, nh, hd)
    v = (xm @ p["wv"]).reshape(bsz, s, nh, hd)
    gif = (xc @ p["w_if"]).float() + p["b_if"]
    log_i, f_pre = gif[..., :nh], gif[..., nh:]              # (B, S, NH)
    log_f = F.logsigmoid(f_pre)

    if mode == "decode":
        y, new_state = _mlstm_step(
            q[:, 0].float(), k[:, 0].float(), v[:, 0].float(), log_i[:, 0],
            log_f[:, 0], (cache["c"], cache["n"], cache["m"]))
        y = y[:, None]
    else:
        y, new_state = _mlstm_chunked(q, k, v, log_i, log_f, cfg.xlstm.chunk,
                                      remat=mode == "train")

    y = y.reshape(bsz, s, d_in).to(dtype)
    h = y * F.silu(z)
    if cache is None:
        return h, None
    return h, {"c": new_state[0], "n": new_state[1], "m": new_state[2],
               "conv": new_conv}


def cache_spec_mlstm(cfg: ModelConfig, batch: int, dtype) -> dict:
    d_in, nh, hd = _dims(cfg)
    kconv = cfg.xlstm.conv_kernel
    return {"c": ((batch, nh, hd, hd), torch.float32),
            "n": ((batch, nh, hd), torch.float32),
            "m": ((batch, nh), torch.float32),
            "conv": ((batch, kconv - 1, d_in), dtype)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def init_slstm(cfg: ModelConfig, dtype, generator, device) -> dict:
    d = cfg.d_model
    nh = cfg.num_heads
    hd = d // nh
    f32 = dict(dtype=torch.float32, device=device)
    return {
        # input projections of the 4 gates (i, f, z, o)
        "w_in": normal_init((d, 4 * d), dtype, generator, device),
        # block-diagonal recurrent weights, per head
        "r": normal_init((nh, hd, 4 * hd), dtype, generator, device),
        "b": torch.cat([torch.zeros(d, **f32), 3.0 * torch.ones(d, **f32),
                        torch.zeros(2 * d, **f32)]),
    }


#: The dtype of the sLSTM's emitted h: bf16 whatever the model dtype, as
#: the JAX scan emits it (the state keeps h in f32).
SLSTM_H_DTYPE = torch.bfloat16


def _slstm_step(c, n, h, m, g_t, rf, bias):
    """One sLSTM step from the state (c, n, h, m), each (B, NH, HD) f32.
    g_t: (B, 4D) the token's input contributions; rf (NH, HD, 4HD) f32.
    Returns the new state; ``h`` stays f32 in the state."""
    bsz, nh, hd = c.shape
    rec = torch.einsum("bhd,hdk->bhk", h, rf)                # (B, NH, 4HD)
    g = (g_t.float().reshape(bsz, nh, 4, hd)
         + rec.reshape(bsz, nh, 4, hd) + bias)
    i_pre, f_pre, z_pre, o_pre = (g[:, :, j] for j in range(4))
    log_f = F.logsigmoid(f_pre)
    m_new = torch.maximum(log_f + m, i_pre)
    i_g = torch.exp(i_pre - m_new)
    f_g = torch.exp(log_f + m - m_new)
    c = f_g * c + i_g * torch.tanh(z_pre)
    n = f_g * n + i_g
    n = torch.maximum(n, torch.tensor(1e-6, dtype=n.dtype, device=n.device))
    h = torch.sigmoid(o_pre) * c / n
    return c, n, h, m_new


def _slstm_scan(gates_in, r, b, nh: int, hd: int, state,
                remat: bool = False):
    """gates_in: (B, S, 4D) precomputed input contributions; ``state``
    (c, n, h, m), each (B, NH, HD) f32. Returns the hidden sequence
    (B, S, NH, HD) in ``SLSTM_H_DTYPE`` and the final state. ``remat``
    (training) checkpoints each step, as the JAX scan's ``jax.checkpoint``
    of its step does."""
    c, n, h, m = state
    rf = r.float()
    bias = b.reshape(nh, 4, hd)[None]
    hs = []
    for t in range(gates_in.shape[1]):
        args = (c, n, h, m, gates_in[:, t], rf, bias)
        if remat:
            c, n, h, m = checkpoint(_slstm_step, *args, use_reentrant=False)
        else:
            c, n, h, m = _slstm_step(*args)
        hs.append(h.to(SLSTM_H_DTYPE))
    return torch.stack(hs, dim=1), (c, n, h, m)


def apply_slstm(p: dict, x: torch.Tensor, ctx, cache: Optional[dict]):
    """x: (B, S, D) -> (y, cache'). On a mesh, an island: ``w_in``
    column-parallel and its products gathered (the JAX package
    constrains ``gates_in`` replicated), the recurrent loop replicated
    over "tp" with the replicated ``r``, and this rank's sequence block
    of its output kept."""
    cfg = ctx.cfg
    bsz, s, d = x.shape
    nh = cfg.num_heads
    hd = d // nh
    mesh = ctx.mesh
    if mesh is None:
        w = p
        gates_in = x @ p["w_in"]                             # (B, S, 4D)
    else:
        from repro_torch.models import transformer as tfm

        w, specs = tfm.mesh_weights(p, ctx, slstm_shapes(cfg), SLSTM_LOGICAL)
        seq_axes = as_axes(ctx.x_spec[1])
        x = tfm.seq_gather(tfm.island_in(x, mesh, ctx.x_spec), mesh,
                           seq_axes)
        bsz, s, _ = x.shape
        gates_in = _gather_cols(x @ w["w_in"], mesh, specs["w_in"][1])
    if cache is not None and ctx.mode == "decode":
        state = (cache["c"], cache["n"], cache["h"], cache["m"])
    else:
        zero = torch.zeros((bsz, nh, hd), dtype=torch.float32,
                           device=x.device)
        state = (zero, zero, zero, zero)
    hs, new_state = _slstm_scan(gates_in, w["r"], w["b"], nh, hd, state,
                                remat=ctx.mode == "train")
    y = hs.reshape(bsz, s, d).to(x.dtype)
    if mesh is not None:
        y = tfm.island_out(tfm.seq_take(y, mesh, seq_axes), mesh,
                           ctx.x_spec)
    if cache is None:
        return y, None
    return y, dict(zip(("c", "n", "h", "m"), new_state))


def cache_spec_slstm(cfg: ModelConfig, batch: int) -> dict:
    shp = (batch, cfg.num_heads, cfg.d_model // cfg.num_heads)
    return {k: (shp, torch.float32) for k in ("c", "n", "h", "m")}
