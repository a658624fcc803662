"""Swin-MoE forward, loss and AdamW training in plain PyTorch, f32.

It follows the port's stated model (``models/swin.py``): f32 layer norms
with the population variance; windowed attention with a learned relative
position bias, softmax in f32; shifted windows rolled by half a window on
every second block, without the cross-window mask, and the window clamped
to the feature map (the JAX package's convention, a departure from the
published Swin); patch merging by 2 x 2 concatenation, norm and a linear
map; the tanh GELU. MoE blocks route each token with a softmax router to
its top-k experts (gates renormalised), run the 2-layer MLP expert and add
the gate-weighted outputs; the loss is the mean cross entropy plus
``aux_weight`` times the mean Switch load-balance loss of the MoE blocks.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from hexabench import inputs
from hexabench.reference import adamw
from hexabench.reference.precision import disable_tf32, matmul


def _ln(p, x, eps):
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]


def _rel_index(w, device):
    r = torch.arange(w, device=device)
    c = torch.stack(torch.meshgrid(r, r, indexing="ij"), -1).reshape(-1, 2)
    rel = c[:, None] - c[None, :] + w - 1
    return rel[..., 0] * (2 * w - 1) + rel[..., 1]


def _attention(p, x, heads, window, mm):
    b, h, w, c = x.shape
    window = min(window, h, w)
    hd, w2 = c // heads, window * window
    nh, nw = h // window, w // window
    xw = x.reshape(b, nh, window, nw, window, c).permute(0, 1, 3, 2, 4, 5)
    xw = xw.reshape(-1, w2, c)
    qkv = mm(xw, p["qkv_w"]) + p["qkv_b"]
    q, k, v = qkv.reshape(-1, w2, 3, heads, hd).permute(2, 0, 3, 1, 4)
    logits = mm(q, k.transpose(-1, -2)) * hd ** -0.5
    bias = p["rel_bias"][_rel_index(window, x.device)].permute(2, 0, 1)
    attn = torch.softmax(logits + bias[None], dim=-1)
    out = mm(attn, v).permute(0, 2, 1, 3).reshape(-1, w2, c)
    out = mm(out, p["proj_w"]) + p["proj_b"]
    out = out.reshape(b, nh, nw, window, window, c).permute(0, 1, 3, 2, 4, 5)
    return out.reshape(b, h, w, c)


def _top_k(v, k):
    vals, idx = torch.sort(v, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _moe(p, x, moe, mm):
    """(y, aux) of a token batch x (N, C)."""
    e, k = moe["num_experts"], moe["top_k"]
    probs = torch.softmax(mm(x, p["router"]), dim=-1)
    gates, idx = _top_k(probs, k)
    if moe["norm_topk"]:
        gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    f_e = F.one_hot(idx, e).float().sum(1).mean(0) / k
    aux = e * torch.sum(f_e * probs.mean(0))
    y = torch.zeros_like(x)
    for j in range(e):
        tok, slot = torch.nonzero(idx == j, as_tuple=True)
        if tok.numel() == 0:
            continue
        h = F.gelu(mm(x[tok], p["w1"][j]) + p["b1"][j], approximate="tanh")
        out = (mm(h, p["w2"][j]) + p["b2"][j]) * gates[tok, slot][:, None]
        y = y.index_add(0, tok, out)
    return y, aux


def forward(p, images, cfg, mm=torch.matmul):
    """(logits (B, classes), mean aux loss of the MoE blocks)."""
    eps, ps = cfg["norm_eps"], cfg["patch_size"]
    b, hi, wi, ci = images.shape
    hp, wp = hi // ps, wi // ps
    x = images[:, :hp * ps, :wp * ps].reshape(b, hp, ps, wp, ps, ci)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, ps * ps * ci)
    x = mm(x, p["patch_w"].reshape(ps * ps * ci, -1)) + p["patch_b"]
    x = _ln(p["patch_ln"], x, eps)
    aux, n_moe = 0.0, 0
    for s, stage in enumerate(p["stages"]):
        for bi, blk in enumerate(stage["blocks"]):
            w_eff = min(cfg["window"], x.shape[1], x.shape[2])
            shift = w_eff // 2 if (bi % 2 == 1 and w_eff < x.shape[1]) else 0
            h = _ln(blk["ln1"], x, eps)
            if shift:
                h = torch.roll(h, (-shift, -shift), dims=(1, 2))
            h = _attention(blk["attn"], h, cfg["heads"][s], cfg["window"], mm)
            if shift:
                h = torch.roll(h, (shift, shift), dims=(1, 2))
            x = x + h
            h = _ln(blk["ln2"], x, eps)
            bb, hh, ww, cc = h.shape
            if "moe" in blk:
                y, a = _moe(blk["moe"], h.reshape(-1, cc), cfg["moe"], mm)
                y = y.reshape(bb, hh, ww, cc)
                aux, n_moe = aux + a, n_moe + 1
            else:
                m = blk["mlp"]
                y = mm(F.gelu(mm(h, m["w1"]) + m["b1"], approximate="tanh"),
                       m["w2"]) + m["b2"]
            x = x + y
        if "merge_w" in stage:
            bb, hh, ww, cc = x.shape
            x = x.reshape(bb, hh // 2, 2, ww // 2, 2, cc)
            x = x.permute(0, 1, 3, 2, 4, 5).reshape(bb, hh // 2, ww // 2,
                                                    4 * cc)
            x = mm(_ln(stage["merge_ln"], x, eps), stage["merge_w"])
    x = _ln(p["final_ln"], x, eps)
    logits = mm(x.mean(dim=(1, 2)), p["head_w"]) + p["head_b"]
    return logits, aux / max(n_moe, 1)


def loss(p, images, labels, cfg, mm=torch.matmul):
    logits, aux = forward(p, images, cfg, mm)
    ce = -torch.log_softmax(logits, -1).gather(-1, labels[:, None]).mean()
    return ce + cfg["train"]["aux_weight"] * aux


def train(cfg: dict, seed: int, batches: list, device,
          precision: str = "f32") -> dict:
    """``len(batches)`` AdamW steps from the seed's weights. Returns, per
    leaf of ``inputs.leaves`` order, the first step's clipped gradient
    norm ("grad") and the norm of the weights' change over all the steps
    ("change"), and each step's loss ("loss")."""
    disable_tf32()
    mm = matmul(precision)
    p = inputs.swin_params(cfg, seed, device)
    named = list(inputs.leaves(p))
    params = [t for _, t in named]
    start = [t.detach().clone() for t in params]
    state, losses, grad = {}, [], None
    for images, labels in batches:
        for t in params:
            t.requires_grad_(True)
        total = loss(p, images, labels, cfg, mm)
        grads = torch.autograd.grad(total, params, allow_unused=True)
        grads = [torch.zeros_like(t) if g is None else g
                 for t, g in zip(params, grads)]
        for t in params:
            t.requires_grad_(False)
        losses.append(float(total.detach()))
        clipped = adamw.step(params, grads, state, cfg["train"]["optimizer"])
        if grad is None:
            grad = [float(torch.linalg.vector_norm(g.double()))
                    for g in clipped]
        del grads, clipped, total
    change = [float(torch.linalg.vector_norm((t - s).double()))
              for t, s in zip(params, start)]
    return {"names": [n for n, _ in named], "loss": losses, "grad": grad,
            "change": change}
