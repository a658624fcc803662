"""Operations and bytes from shapes: the benchmark's own count, never the
program's. Multiply-adds count 2 operations; elementwise work (norms,
activations, softmax) is not counted. A backward counts twice its
forward, without recompute.
"""
from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "int8": 1}


def peaks() -> dict:
    with open(HERE / "peaks.json") as fh:
        return json.load(fh)


def bound_s(flops: float, nbytes: float, dtype: str) -> float:
    """The least time the chip could take: the larger of the operations
    over the peak of ``dtype`` and the bytes over the memory rate."""
    p = peaks()
    return max(flops / p["flops_per_s"][dtype], nbytes / p["bytes_per_s"])


# ---------------------------------------------------------------------------
# Swin-MoE
# ---------------------------------------------------------------------------

def swin_stage_tokens(cfg: dict) -> list:
    """Feature-map side of each stage."""
    side = cfg["img_size"] // cfg["patch_size"]
    return [side >> s for s in range(len(cfg["depths"]))]


def swin_forward_flops(cfg: dict, batch: int) -> float:
    """One forward of ``batch`` images: patch embedding, each block's
    qkv/proj, windowed attention (scores and values), FFN (dense or the
    top-k experts' MLPs) and router, the patch merges and the head."""
    sides = swin_stage_tokens(cfg)
    ps, c0 = cfg["patch_size"], cfg["dims"][0]
    k, e = cfg["moe"]["top_k"], cfg["moe"]["num_experts"]
    total = 2 * sides[0] ** 2 * ps * ps * cfg["in_chans"] * c0
    for s, depth in enumerate(cfg["depths"]):
        n, c = sides[s] ** 2, cfg["dims"][s]
        w = min(cfg["window"], sides[s])
        hidden = int(cfg["mlp_ratio"] * c)
        for b in range(depth):
            total += 2 * n * c * 3 * c + 2 * n * c * c      # qkv, proj
            total += 4 * n * w * w * c                      # q k^T, p v
            if s in cfg["moe_stages"] and b % 2 == 1:
                total += 2 * n * c * e + k * 4 * n * c * hidden
            else:
                total += 4 * n * c * hidden
        if s < len(cfg["depths"]) - 1:
            total += 2 * (n // 4) * 4 * c * 2 * c           # patch merge
    total += 2 * cfg["dims"][-1] * cfg["num_classes"]
    return float(total * batch)


def swin_train_flops(cfg: dict, batch: int) -> float:
    return 3.0 * swin_forward_flops(cfg, batch)


def swin_expert_layers(cfg: dict, batch: int) -> list:
    """(rows, tokens, dim, hidden) of each MoE block of one step: rows are
    the routed (token, expert) pairs, tokens * top_k (no drops)."""
    sides = swin_stage_tokens(cfg)
    out = []
    for s, depth in enumerate(cfg["depths"]):
        for b in range(depth):
            if s in cfg["moe_stages"] and b % 2 == 1:
                tokens = batch * sides[s] ** 2
                c = cfg["dims"][s]
                out.append((tokens * cfg["moe"]["top_k"], tokens, c,
                            int(cfg["mlp_ratio"] * c)))
    return out


def expert_mlp_train_work(rows: int, tokens: int, d: int, h: int,
                          experts: int, nbytes: int) -> tuple:
    """(operations, bytes) of an MLP expert FFN's forward and backward for
    ``rows`` routed rows: forward x W1 and h W2; backward dX and dW of
    both. Bytes: the tokens in, the rows' outputs, dy and dx, each weight
    and bias read twice (forward, backward) and its gradient written."""
    flops = 3 * (2 * rows * d * h * 2)
    weights = experts * (2 * d * h + h + d)
    act = 2 * tokens * d + 2 * rows * d
    return float(flops), float(nbytes * (3 * weights + 2 * act))


def swin_expert_bound_s(cfg: dict, batch: int) -> float:
    """The least time of one step's expert FFNs, forward and backward."""
    e, nb = cfg["moe"]["num_experts"], DTYPE_BYTES[cfg["dtype"]]
    return sum(bound_s(*expert_mlp_train_work(r, t, d, h, e, nb), cfg["dtype"])
               for r, t, d, h in swin_expert_layers(cfg, batch))


# ---------------------------------------------------------------------------
# decoder LMs
# ---------------------------------------------------------------------------

def lm_token_flops(cfg: dict, context: int) -> float:
    """One token's forward through every layer, attending to ``context``
    keys (itself included; capped by the window): the q/k/v/o projections,
    scores and values, the router and the top-k GLU experts."""
    d, hq, hkv, hd = (cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"],
                      cfg["head_dim"])
    m = cfg["moe"]
    if cfg.get("window"):
        context = min(context, cfg["window"])
    proj = 2 * d * (hq + 2 * hkv) * hd + 2 * hq * hd * d
    attn = 4 * hq * hd * context
    moe = 2 * d * m["num_experts"] + m["top_k"] * 3 * 2 * d * m["d_ff"]
    return float(cfg["num_layers"] * (proj + attn + moe))


def lm_head_flops(cfg: dict) -> float:
    return float(2 * cfg["d_model"] * cfg["vocab_size"])


def expert_glu_launch_work(rows: int, tokens: int, touched: int, d: int,
                           f: int, wbytes: int, xbytes: int,
                           tile: int = 128) -> tuple:
    """(operations, bytes) of one GLU expert FFN forward over ``rows``
    routed rows of ``tokens`` tokens: gate, up and down products; the
    ``touched`` experts' three matrices (and, for 8-bit weights, their
    block scales) read once, the tokens read and the rows written."""
    flops = 3 * 2 * rows * d * f
    weights = touched * 3 * d * f * wbytes
    if wbytes == 1:
        weights += touched * 3 * (d // tile) * (f // tile) * 4
    return float(flops), float(weights + xbytes * (tokens * d + rows * d))
