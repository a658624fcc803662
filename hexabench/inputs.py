"""Every input of a run, made from ``--seed``: weights, images, labels and
token ids. The same function makes an input for the program and, after
the window, again for the reference, so both see the same numbers without
the reference reading anything the program holds.

Imports torch only. Each draw comes from its own ``torch.Generator``,
seeded from ``(seed, name...)`` by ``derive_seed``: a layer or a batch can
be drawn again on its own, in any order.
"""
from __future__ import annotations

import hashlib
import math

import torch

INIT_STD = 0.02        # the port's normal init (``sharding.normal_init``)
QUANT_MAX = {"int8": 127.0}
QUANT_TILE = 128


def derive_seed(seed: int, *keys) -> int:
    """A 63-bit seed for the stream ``keys`` of run ``seed``."""
    digest = hashlib.sha256(repr((int(seed),) + keys).encode()).digest()
    return int.from_bytes(digest[:8], "little") & ((1 << 63) - 1)


def generator(device, seed: int, *keys) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(derive_seed(seed, *keys))
    return gen


def leaves(tree, prefix: str = ""):
    """``(path, tensor)`` of every tensor in a tree of dicts and lists,
    dict keys sorted."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], f"{prefix}{k}/")
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from leaves(v, f"{prefix}{i}/")
    elif tree is not None:
        yield prefix.rstrip("/"), tree


def _normals(shapes, gen, device, dtype, std=INIT_STD):
    """One f32 normal draw for all ``shapes``, cut into tensors of
    ``dtype``."""
    sizes = [math.prod(s) for s in shapes]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    flat.normal_(0.0, std, generator=gen)
    out = [t.view(s).to(dtype).clone() if dtype == torch.float32
           else t.view(s).to(dtype)
           for t, s in zip(torch.split(flat, sizes), shapes)]
    del flat
    return out


# ---------------------------------------------------------------------------
# Swin-MoE
# ---------------------------------------------------------------------------

def swin_shapes(cfg: dict) -> dict:
    """The parameter tree of ``models/swin.py`` as shapes, with each leaf's
    init: ("normal" | "zeros" | "ones", shape)."""
    def ln(d):
        return {"scale": ("ones", (d,)), "bias": ("zeros", (d,))}

    ps, w, e = cfg["patch_size"], cfg["window"], cfg["moe"]["num_experts"]
    tree = {
        "patch_w": ("normal", (ps, ps, cfg["in_chans"], cfg["dims"][0])),
        "patch_b": ("zeros", (cfg["dims"][0],)),
        "patch_ln": ln(cfg["dims"][0]),
        "final_ln": ln(cfg["dims"][-1]),
        "head_w": ("normal", (cfg["dims"][-1], cfg["num_classes"])),
        "head_b": ("zeros", (cfg["num_classes"],)),
        "stages": [],
    }
    for s, depth in enumerate(cfg["depths"]):
        dim, heads = cfg["dims"][s], cfg["heads"][s]
        hidden = int(cfg["mlp_ratio"] * dim)
        blocks = []
        for b in range(depth):
            blk = {
                "ln1": ln(dim), "ln2": ln(dim),
                "attn": {"qkv_w": ("normal", (dim, 3 * dim)),
                         "qkv_b": ("zeros", (3 * dim,)),
                         "proj_w": ("normal", (dim, dim)),
                         "proj_b": ("zeros", (dim,)),
                         "rel_bias": ("normal", ((2 * w - 1) ** 2, heads))},
            }
            if swin_is_moe(cfg, s, b):
                blk["moe"] = {"router": ("normal", (dim, e)),
                              "w1": ("normal", (e, dim, hidden)),
                              "b1": ("zeros", (e, hidden)),
                              "w2": ("normal", (e, hidden, dim)),
                              "b2": ("zeros", (e, dim))}
            else:
                blk["mlp"] = {"w1": ("normal", (dim, hidden)),
                              "b1": ("zeros", (hidden,)),
                              "w2": ("normal", (hidden, dim)),
                              "b2": ("zeros", (dim,))}
            blocks.append(blk)
        stage = {"blocks": blocks}
        if s < len(cfg["depths"]) - 1:
            stage["merge_w"] = ("normal", (4 * dim, 2 * dim))
            stage["merge_ln"] = ln(4 * dim)
        tree["stages"].append(stage)
    return tree


def swin_is_moe(cfg: dict, stage: int, blk: int) -> bool:
    return stage in cfg["moe_stages"] and blk % 2 == 1


def swin_params(cfg: dict, seed: int, device) -> dict:
    """Swin-MoE's f32 parameters in the port's layout: every weight from
    one normal draw of the seed's "swin" stream, biases 0, norm scales 1."""
    spec = swin_shapes(cfg)
    normal = [s for _, s in leaves(spec) if s[0] == "normal"]
    drawn = iter(_normals([s[1] for s in normal],
                          generator(device, seed, "swin"), device,
                          torch.float32))

    def build(node):
        if isinstance(node, dict):
            return {k: build(node[k]) for k in sorted(node)}
        if isinstance(node, list):
            return [build(v) for v in node]
        kind, shape = node
        if kind == "normal":
            return next(drawn)
        fill = torch.ones if kind == "ones" else torch.zeros
        return fill(shape, dtype=torch.float32, device=device)

    return build(spec)


def image_batch(cfg: dict, batch: int, gen: torch.Generator, device):
    """(images (B, H, W, C) f32 standard normal, labels (B,) int64)."""
    size = cfg["img_size"]
    images = torch.randn((batch, size, size, cfg["in_chans"]),
                         generator=gen, device=device)
    labels = torch.randint(0, cfg["num_classes"], (batch,), generator=gen,
                           device=device)
    return images, labels


# ---------------------------------------------------------------------------
# decoder LMs (models/lm.py's layout)
# ---------------------------------------------------------------------------

def quantize_blockwise(w: torch.Tensor, mode: str = "int8",
                       tile: int = QUANT_TILE):
    """Symmetric block-wise quantization over the trailing two dims, one f32
    scale per (tile x tile) block: ``q = clip(round(w / s), -Q, Q)`` with
    ``s = max(amax(block), 1e-30) / Q`` (``quant.core``'s convention)."""
    qmax = QUANT_MAX[mode]
    a, b = w.shape[-2:]
    ta, tb = min(tile, a), min(tile, b)
    blocks = w.float().reshape(*w.shape[:-2], a // ta, ta, b // tb, tb)
    amax = blocks.abs().amax(dim=(-3, -1))
    scale = torch.clamp(amax, min=1e-30) / qmax
    q = torch.clamp(torch.round(blocks / scale[..., :, None, :, None]),
                    -qmax, qmax)
    return q.to(torch.int8).reshape(w.shape), scale


def dequantize_blockwise(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """f32 weights of ``quantize_blockwise``'s ``(q, scale)``."""
    a, b = q.shape[-2:]
    na, nb = scale.shape[-2:]
    w = q.float().reshape(*q.shape[:-2], na, a // na, nb, b // nb)
    return (w * scale[..., :, None, :, None]).reshape(q.shape)


def lm_layer(cfg: dict, seed: int, idx: int, device, *,
             quant: str | None = None) -> dict:
    """Decoder layer ``idx`` of an attention + MoE (GLU experts) stack:
    the attention weights and the router in a few draws, then each expert
    matrix drawn alone and, with ``quant``, quantized as it is drawn, so
    no full-precision copy of the layer's experts exists. The matrices
    that write into the residual stream (``wo``, ``w_down``) are drawn at
    ``init.out_scale`` times the std where the configuration sets it."""
    d, hq, hkv = cfg["d_model"], cfg["num_heads"], cfg["num_kv_heads"]
    hd = cfg["head_dim"]
    m = cfg["moe"]
    e, f = m["num_experts"], m["d_ff"]
    dtype = getattr(torch, cfg["dtype"])
    gen = generator(device, seed, "layer", idx)
    out_std = INIT_STD * cfg.get("init", {}).get("out_scale", 1.0)
    wq, wk, wv = _normals([(d, hq * hd), (d, hkv * hd), (d, hkv * hd)],
                          gen, device, dtype)
    wo, = _normals([(hq * hd, d)], gen, device, dtype, std=out_std)
    router, = _normals([(d, e)], gen, device, torch.float32)
    ffn = {"router": router}
    for name, shape in (("w_gate", (d, f)), ("w_up", (d, f)),
                        ("w_down", (f, d))):
        if quant is None:
            ffn[name] = torch.empty((e, *shape), dtype=dtype, device=device)
        else:
            ffn[name] = torch.empty((e, *shape), dtype=torch.int8,
                                    device=device)
            ffn[f"{name}_scale"] = torch.empty(
                (e, shape[0] // min(QUANT_TILE, shape[0]),
                 shape[1] // min(QUANT_TILE, shape[1])),
                dtype=torch.float32, device=device)
        for x in range(e):
            w, = _normals([shape], gen, device, torch.float32,
                          std=out_std if name == "w_down" else INIT_STD)
            if quant is None:
                ffn[name][x] = w.to(dtype)
            else:
                ffn[name][x], ffn[f"{name}_scale"][x] = quantize_blockwise(
                    w, quant)
            del w
    ones = lambda: {"scale": torch.ones(d, dtype=torch.float32,  # noqa: E731
                                        device=device)}
    return {"ln1": ones(), "ln2": ones(),
            "mixer": {"wq": wq, "wk": wk, "wv": wv, "wo": wo}, "ffn": ffn}


def lm_embed_head(cfg: dict, seed: int, device) -> dict:
    """The embedding (V, D), the head (D, V) and the final norm."""
    d, v = cfg["d_model"], cfg["vocab_size"]
    dtype = getattr(torch, cfg["dtype"])
    gen = generator(device, seed, "embed_head")
    embed, = _normals([(v, d)], gen, device, dtype,
                      std=cfg.get("init", {}).get("embed_std", INIT_STD))
    head, = _normals([(d, v)], gen, device, dtype)
    return {"embed": embed, "head": head,
            "final_norm": {"scale": torch.ones(d, dtype=torch.float32,
                                               device=device)}}


def lm_params(cfg: dict, seed: int, device, *, quant: str | None = None
              ) -> dict:
    """The whole tree of ``models/lm.py`` (untied head)."""
    p = lm_embed_head(cfg, seed, device)
    p["layers"] = [lm_layer(cfg, seed, i, device, quant=quant)
                   for i in range(cfg["num_layers"])]
    return p
