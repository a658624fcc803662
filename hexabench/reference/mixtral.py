"""A decoder LM of attention and top-k GLU experts (Mixtral's block) in
plain PyTorch, f32: the full forward of whole sequences, no cache.

RMSNorm; grouped-query attention with rotary embeddings (rotate-half,
``theta ** (-i / half)``), causal, within a sliding window where the
configuration has one; a softmax over the top-k router logits as the
gates (Mixtral's ``softmax_after_topk``); SiLU-gated experts. 8-bit
experts are dequantized (``inputs.dequantize_blockwise``) to f32.

It runs layer by layer: each layer's weights are drawn again from the seed
(``inputs.lm_layer``), used for every sequence and freed, so the peak is
one layer's f32 weights and the sequences' activations.
"""
from __future__ import annotations

import torch

from hexabench import inputs
from hexabench.reference.precision import disable_tf32, matmul


def _rms(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def _rope(x, theta):
    """x: (S, H, hd) at positions 0..S-1."""
    s, _, hd = x.shape
    half = hd // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32,
                                    device=x.device) / half)
    ang = torch.arange(s, dtype=torch.float32,
                       device=x.device)[:, None] * freqs
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(lay, x, cfg, mm):
    s = x.shape[0]
    hq, hkv, hd = cfg["num_heads"], cfg["num_kv_heads"], cfg["head_dim"]
    q = _rope(mm(x, lay["wq"]).reshape(s, hq, hd), cfg["rope_theta"])
    k = _rope(mm(x, lay["wk"]).reshape(s, hkv, hd), cfg["rope_theta"])
    v = mm(x, lay["wv"]).reshape(s, hkv, hd)
    g = hq // hkv
    k = k.repeat_interleave(g, dim=1).permute(1, 2, 0)       # (hq, hd, S)
    v = v.repeat_interleave(g, dim=1).permute(1, 0, 2)       # (hq, S, hd)
    logits = mm(q.permute(1, 0, 2), k) * hd ** -0.5          # (hq, S, S)
    pos = torch.arange(s, device=x.device)
    allowed = pos[None, :] <= pos[:, None]
    if cfg.get("window"):
        allowed &= pos[None, :] > pos[:, None] - cfg["window"]
    logits = logits.masked_fill(~allowed, float("-inf"))
    out = mm(torch.softmax(logits, -1), v).permute(1, 0, 2).reshape(s, -1)
    return mm(out, lay["wo"])


def _moe(lay, x, cfg, mm):
    m = cfg["moe"]
    logits = mm(x, lay["router"])
    vals, idx = torch.sort(logits, dim=-1, descending=True, stable=True)
    vals, idx = vals[:, :m["top_k"]], idx[:, :m["top_k"]]
    gates = torch.softmax(vals, dim=-1)
    y = torch.zeros_like(x)
    for e in range(m["num_experts"]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        h = torch.nn.functional.silu(mm(xe, lay["w_gate"][e])) \
            * mm(xe, lay["w_up"][e])
        y.index_add_(0, tok,
                     mm(h, lay["w_down"][e]) * gates[tok, slot][:, None])
    return y


def _layer_f32(cfg, seed, idx, device, quant):
    raw = inputs.lm_layer(cfg, seed, idx, device, quant=quant)
    lay = {k: v.float() for k, v in raw["mixer"].items()}
    ffn = raw["ffn"]
    lay["router"] = ffn["router"].float()
    for name in ("w_gate", "w_up", "w_down"):
        scale = ffn.get(f"{name}_scale")
        lay[name] = (ffn[name].float() if scale is None
                     else inputs.dequantize_blockwise(ffn[name], scale))
    lay["ln1"], lay["ln2"] = raw["ln1"]["scale"], raw["ln2"]["scale"]
    del raw
    return lay


@torch.no_grad()
def logits_at(cfg: dict, seed: int, device, seqs: list, positions: list,
              *, quant=None, precision: str = "f32") -> list:
    """For each token sequence ``seqs[i]`` (1-d int64), the logits
    (len(positions[i]), V) at the positions ``positions[i]``."""
    disable_tf32()
    mm = matmul(precision)
    eps = cfg["norm_eps"]
    eh = inputs.lm_embed_head(cfg, seed, device)
    xs = [eh["embed"].float()[torch.as_tensor(t, device=device).long()]
          for t in seqs]
    for i in range(cfg["num_layers"]):
        lay = _layer_f32(cfg, seed, i, device, quant)
        for j, x in enumerate(xs):
            x = x + _attention(lay, _rms(x, lay["ln1"], eps), cfg, mm)
            xs[j] = x + _moe(lay, _rms(x, lay["ln2"], eps), cfg, mm)
        del lay
    head = eh["head"].float()
    out = []
    for x, pos in zip(xs, positions):
        h = _rms(x[torch.as_tensor(pos, device=device).long()],
                 eh["final_norm"]["scale"], eps)
        out.append(mm(h, head))
    return out
