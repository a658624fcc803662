"""Swin-Transformer-MoE — the paper's benchmark model (§5, Tutel setup;
counterpart of ``repro.models.swin``).

Hierarchical windowed-attention vision transformer with the FFN of
alternating blocks in the last two stages replaced by an MoE FFN of the
paper's 2-MLP expert form (GeLU between, with biases), through any of the
paper's execution paths (``moe_impl``):

  "hexa"        the expert-specific ops (the paper's method):
                ``parallel.moe_parallel.moe_layer`` -> ``core.espec.
                moe_mlp`` -> ``kernels.ops.esffn_mlp``
  "tutel"       dispatch/combine into a capacity buffer of
                ``ParallelConfig.capacity_factor`` (``core.baselines.
                dispatch_combine_moe``: pads and drops)
  "megablocks"  the worst-case-capacity grouped dense GEMM
                (``core.baselines.grouped_dense_moe``: pads, never drops)

The baselines route the flat tokens with ``core.routing.route`` as the
hexa path does, so all three see the same ``RouterOutput``.

As in the JAX package, shifted windows roll without the cross-window
attention mask, and the window is clamped to the feature map (a 7 x 7 map
with window 7 gets one window and no shift). Leaves keep the JAX layouts
(``patch_w`` HWIO, ``qkv_w`` (C, 3C), ``rel_bias`` ((2w-1)^2, heads)), so
``convert.swin_params_from_jax`` carries weights across as a copy.

``make_train_step`` is the counterpart of ``benchmarks/memory_table.py::
make_train_fn``: cross entropy + 0.01 aux, AdamW. Like it, the forward
saves every activation (no rematerialisation: ``ParallelConfig.remat`` is
not read here). Entry points run on the GPU unless given another device.

On a mesh (``launch.mesh.Mesh`` with "pod", "data" and "model" axes) the
dense layers run data-parallel: each rank holds the batch rows of its
("pod", "data") group, replicated over "model", and the whole dense
weights. The MoE blocks go through ``moe_layer`` with the tokens placed
``(("pod", "data"), None, None)``, as the JAX package's do, each rank
holding its shards of the expert weights (``param_specs``; the JAX tree
tags its dense weights fsdp/tp for GSPMD, whose placement of the dense
layers is its own choice: the values agree). A mesh without a "pod" axis
raises ``ValueError``, as JAX's ``shard_map`` does on that path.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch.profiler import record_function

from repro_torch.common import (
    ACTIVATIONS,
    resolve_device,
    torch_dtype,
    tree_leaves,
    tree_map,
)
from repro_torch.configs.base import MoEConfig
from repro_torch.core import baselines
from repro_torch.core.routing import route
from repro_torch.optim import adamw
from repro_torch.parallel.moe_parallel import (
    EP_PARAM_LOGICAL,
    MOE_PARAM_LOGICAL,
    MoEStatic,
    _param_specs,
    moe_layer,
)
from repro_torch.parallel.sharding import (
    ParallelConfig,
    normal_init,
    spec_axes,
)

#: The MoE blocks' token placement on a mesh (the JAX package's).
SWIN_X_SPEC = (("pod", "data"), None, None)


@dataclasses.dataclass(frozen=True)
class SwinConfig:
    name: str
    family: str = "vision-moe"
    img_size: int = 224
    patch_size: int = 4
    in_chans: int = 3
    depths: Tuple[int, ...] = (2, 2, 18, 2)
    dims: Tuple[int, ...] = (96, 192, 384, 768)
    heads: Tuple[int, ...] = (3, 6, 12, 24)
    window: int = 7
    mlp_ratio: float = 4.0
    num_classes: int = 1000
    moe_stages: Tuple[int, ...] = (2, 3)
    moe: Optional[MoEConfig] = None
    norm_eps: float = 1e-5
    dtype: str = "float32"

    def is_moe_block(self, stage: int, blk: int) -> bool:
        return self.moe is not None and stage in self.moe_stages and blk % 2 == 1


SWIN_SMALL = dict(depths=(2, 2, 18, 2), dims=(96, 192, 384, 768),
                  heads=(3, 6, 12, 24))
SWIN_BASE = dict(depths=(2, 2, 18, 2), dims=(128, 256, 512, 1024),
                 heads=(4, 8, 16, 32))

AUX_WEIGHT = 0.01     # make_train_fn's loss: ce + 0.01 * aux (z unused)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _zeros(shape, device):
    return torch.zeros(shape, dtype=torch.float32, device=device)


def _init_ln(d, device):
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": _zeros((d,), device)}


def init_swin(cfg: SwinConfig, *, generator: torch.Generator,
              device=None) -> dict:
    """Full parameter tree, drawn from ``generator`` (on ``device``, the GPU
    unless given): the JAX package's shapes, dtypes and 0.02-std normal,
    not its numbers. Biases start at zero, layer-norm scales at one."""
    device = resolve_device(device)
    dtype = torch_dtype(cfg.dtype)

    def normal(shape, dt=dtype):
        return normal_init(shape, dt, generator, device)

    p: dict = {
        "patch_w": normal((cfg.patch_size, cfg.patch_size, cfg.in_chans,
                           cfg.dims[0])),
        "patch_b": _zeros((cfg.dims[0],), device),
        "patch_ln": _init_ln(cfg.dims[0], device),
        "stages": [],
        "final_ln": _init_ln(cfg.dims[-1], device),
        "head_w": normal((cfg.dims[-1], cfg.num_classes)),
        "head_b": _zeros((cfg.num_classes,), device),
    }
    for s, depth in enumerate(cfg.depths):
        dim, heads = cfg.dims[s], cfg.heads[s]
        hidden = int(cfg.mlp_ratio * dim)
        blocks = []
        for b in range(depth):
            blk = {
                "ln1": _init_ln(dim, device),
                "attn": {
                    "qkv_w": normal((dim, 3 * dim)),
                    "qkv_b": _zeros((3 * dim,), device),
                    "proj_w": normal((dim, dim)),
                    "proj_b": _zeros((dim,), device),
                    "rel_bias": normal(((2 * cfg.window - 1) ** 2, heads),
                                       torch.float32),
                },
                "ln2": _init_ln(dim, device),
            }
            if cfg.is_moe_block(s, b):
                e = cfg.moe.num_experts
                blk["moe"] = {
                    "router": normal((dim, e), torch.float32),
                    "w1": normal((e, dim, hidden)),
                    "b1": _zeros((e, hidden), device),
                    "w2": normal((e, hidden, dim)),
                    "b2": _zeros((e, dim), device),
                }
            else:
                blk["mlp"] = {
                    "w1": normal((dim, hidden)),
                    "b1": _zeros((hidden,), device),
                    "w2": normal((hidden, dim)),
                    "b2": _zeros((dim,), device),
                }
            blocks.append(blk)
        stage = {"blocks": blocks}
        if s < len(cfg.depths) - 1:
            stage["merge_w"] = normal((4 * dim, 2 * dim))
            stage["merge_ln"] = _init_ln(4 * dim, device)
        p["stages"].append(stage)
    return p


# ---------------------------------------------------------------------------
# apply
# ---------------------------------------------------------------------------

def _ln(p, x, eps):
    """Layer norm in f32 with the population variance (``jnp.var``)."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps) * p["scale"]
            + p["bias"]).to(x.dtype)


def _rel_bias_index(window: int, device) -> torch.Tensor:
    """(w^2, w^2) index into the ((2w-1)^2, heads) relative-position table."""
    r = torch.arange(window, device=device)
    coords = torch.stack(torch.meshgrid(r, r, indexing="ij"), -1).reshape(-1, 2)
    rel = coords[:, None] - coords[None, :] + window - 1
    return rel[..., 0] * (2 * window - 1) + rel[..., 1]


def _window_attention(p, x, heads, window):
    """x: (B, H, W, C) -> same, windowed MSA; logits and softmax in f32,
    the attention weights cast back to x.dtype."""
    b, h, w, c = x.shape
    window = min(window, h, w)  # Swin clamps when window > feature map
    hd = c // heads
    nwh, nww = h // window, w // window
    w2 = window * window
    xw = x.reshape(b, nwh, window, nww, window, c)
    xw = xw.permute(0, 1, 3, 2, 4, 5).reshape(-1, w2, c)

    qkv = xw @ p["qkv_w"].to(xw.dtype) + p["qkv_b"].to(xw.dtype)
    q, k, v = qkv.reshape(-1, w2, 3, heads, hd).unbind(2)  # (nB, w2, h, hd)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) \
        * hd ** -0.5
    bias = p["rel_bias"][_rel_bias_index(window, x.device)]  # (w2, w2, h)
    logits = logits + bias.permute(2, 0, 1)[None]
    attn = torch.softmax(logits, -1).to(xw.dtype)
    out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(-1, w2, c)
    out = out @ p["proj_w"].to(xw.dtype) + p["proj_b"].to(xw.dtype)

    out = out.reshape(b, nwh, nww, window, window, c)
    return out.permute(0, 1, 3, 2, 4, 5).reshape(b, h, w, c)


def _moe_static(cfg: SwinConfig, dim: int) -> MoEStatic:
    m = cfg.moe
    return MoEStatic(num_experts=m.num_experts, top_k=m.top_k, act="gelu",
                     glu=False, norm_topk=m.norm_topk,
                     softmax_after_topk=m.softmax_after_topk,
                     d_ff=int(cfg.mlp_ratio * dim))


def _apply_moe_ffn(p, x_tokens, cfg: SwinConfig, pcfg: ParallelConfig,
                   moe_impl: str, mesh=None):
    """x_tokens: (B, L, C) -> (y, aux, z) through ``moe_impl``'s path."""
    m = cfg.moe
    if moe_impl == "hexa":
        return moe_layer(x_tokens, p, _moe_static(cfg, x_tokens.shape[-1]),
                         pcfg, mesh, x_spec=SWIN_X_SPEC)
    if mesh is not None:
        raise NotImplementedError(
            f"moe_impl {moe_impl!r} on a mesh: the baselines' distributed "
            f"paths are not ported (ROADMAP.md A.5)")
    bsz, seq, c = x_tokens.shape
    xf = x_tokens.reshape(bsz * seq, c)
    r = route(xf, p["router"], m.top_k, norm_topk=m.norm_topk,
              softmax_after_topk=m.softmax_after_topk)
    gelu = ACTIVATIONS["gelu"]           # tanh form, as jax.nn.gelu
    if moe_impl == "tutel":
        y = baselines.dispatch_combine_moe(
            xf, r, p["w1"], p["b1"], p["w2"], p["b2"], act=gelu,
            capacity_factor=pcfg.capacity_factor)
    elif moe_impl == "megablocks":
        y = baselines.grouped_dense_moe(xf, r, p["w1"], p["b1"], p["w2"],
                                        p["b2"], act=gelu)
    else:
        raise ValueError(f"moe_impl {moe_impl!r}: hexa | tutel | megablocks")
    return y.reshape(bsz, seq, c), r.aux_loss, r.z_loss


def check_mesh(mesh) -> None:
    """Swin's MoE islands place their tokens over ("pod", "data"): a mesh
    that lacks either axis is refused, as the JAX package's ``shard_map``
    refuses it."""
    if mesh is None:
        return
    missing = [a for a in ("pod", "data") if a not in mesh.axis_names]
    if missing:
        raise ValueError(f"Swin's MoE islands shard tokens over ('pod', "
                         f"'data'); the mesh {mesh.axis_names} lacks "
                         f"{missing}")


def param_specs(cfg: SwinConfig, pcfg: ParallelConfig) -> dict:
    """Logical spec of every leaf, in the parameter tree's structure: the
    MoE leaves as ``moe_parallel`` places them under ``pcfg.mode``, every
    other leaf replicated (the dense layers run data-parallel)."""
    table = EP_PARAM_LOGICAL if pcfg.mode == "ep" else MOE_PARAM_LOGICAL
    shapes = param_shapes(cfg)

    def walk(tree, in_moe=False):
        if isinstance(tree, dict):
            return {k: (walk(v, True) if k == "moe" else
                        table[k] if in_moe else walk(v, in_moe))
                    for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, in_moe) for v in tree]
        return (None,) * len(tree)

    return walk(shapes)


def param_shapes(cfg: SwinConfig) -> dict:
    """Every leaf's global shape, in the parameter tree's structure."""
    p = init_swin(cfg, generator=torch.Generator(), device="meta")
    return tree_map(lambda t: tuple(t.shape), p)


def _moe_leaf_axes(cfg: SwinConfig, pcfg: ParallelConfig, mesh) -> dict:
    """stage -> {MoE leaf name: the mesh axes its block is sharded over}."""
    out = {}
    for s in cfg.moe_stages:
        dim = cfg.dims[s]
        specs = _param_specs(_moe_static(cfg, dim), dim, pcfg, mesh)
        out[s] = {k: tuple(a for a in mesh.axis_names if a in spec_axes(v))
                  for k, v in specs.items()}
    return out


def swin_forward(params, images: torch.Tensor, cfg: SwinConfig,
                 pcfg: ParallelConfig, mesh=None, *, moe_impl: str = "hexa"):
    """images: (B, H, W, 3) -> (logits (B, classes) f32, aux, z), the MoE
    losses averaged over the MoE blocks; ``moe_impl`` is "hexa", "tutel"
    or "megablocks" (any other raises ``ValueError`` at the first MoE
    block). On a ``mesh``: this rank's images and parameter shards, its
    logits, and the global aux and z."""
    check_mesh(mesh)
    dtype = torch_dtype(cfg.dtype)
    # The stride-p, p x p VALID patch convolution as one matmul over the
    # flattened (kh, kw, c) patches, in the HWIO weight's order.
    ps = cfg.patch_size
    b, hi, wi, ci = images.shape
    hp, wp = hi // ps, wi // ps
    x = images[:, :hp * ps, :wp * ps].to(dtype)
    x = x.reshape(b, hp, ps, wp, ps, ci).permute(0, 1, 3, 2, 4, 5)
    x = x.reshape(b, hp, wp, ps * ps * ci)
    x = x @ params["patch_w"].to(dtype).reshape(ps * ps * ci, -1) \
        + params["patch_b"].to(dtype)
    x = _ln(params["patch_ln"], x, cfg.norm_eps)

    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    z_total = torch.zeros((), dtype=torch.float32, device=x.device)
    n_moe = 0
    gelu = ACTIVATIONS["gelu"]           # tanh form, as jax.nn.gelu
    for s, stage in enumerate(params["stages"]):
        heads = cfg.heads[s]
        for bidx, blk in enumerate(stage["blocks"]):
            w_eff = min(cfg.window, x.shape[1], x.shape[2])
            shift = (w_eff // 2) if (bidx % 2 == 1 and w_eff < x.shape[1]) \
                else 0
            h = _ln(blk["ln1"], x, cfg.norm_eps)
            if shift:
                h = torch.roll(h, (-shift, -shift), dims=(1, 2))
            h = _window_attention(blk["attn"], h, heads, cfg.window)
            if shift:
                h = torch.roll(h, (shift, shift), dims=(1, 2))
            x = x + h
            h = _ln(blk["ln2"], x, cfg.norm_eps)
            bb, hh, ww, cc = h.shape
            if "moe" in blk:
                y, aux, z = _apply_moe_ffn(blk["moe"],
                                           h.reshape(bb, hh * ww, cc), cfg,
                                           pcfg, moe_impl, mesh)
                y = y.reshape(bb, hh, ww, cc)
                aux_total = aux_total + aux
                z_total = z_total + z
                n_moe += 1
            else:
                m = blk["mlp"]
                y = gelu(h @ m["w1"].to(dtype) + m["b1"].to(dtype)) \
                    @ m["w2"].to(dtype) + m["b2"].to(dtype)
            x = x + y
        if "merge_w" in stage:
            bb, hh, ww, cc = x.shape
            x = x.reshape(bb, hh // 2, 2, ww // 2, 2, cc)
            x = x.permute(0, 1, 3, 2, 4, 5).reshape(bb, hh // 2, ww // 2,
                                                    4 * cc)
            x = _ln(stage["merge_ln"], x, cfg.norm_eps)
            x = x @ stage["merge_w"].to(dtype)

    x = _ln(params["final_ln"], x, cfg.norm_eps)
    pooled = x.mean(dim=(1, 2)).float()
    logits = pooled @ params["head_w"].float() + params["head_b"]
    denom = max(n_moe, 1)
    return logits, aux_total / denom, z_total / denom


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def make_loss_fn(cfg: SwinConfig, pcfg: ParallelConfig, *,
                 moe_impl: str = "hexa", mesh=None):
    """``loss_fn(params, images, labels) -> (ce + 0.01 aux, metrics)``:
    mean cross entropy of the f32 logits; the z loss is reported only.
    ``moe_impl`` as ``swin_forward``'s.

    On a ``mesh`` each rank's loss is its share of the global loss for the
    backward (``moe_parallel``'s convention: every term counted whole on
    each rank that holds it): its rows' mean cross entropy over the number
    of ("pod", "data") groups, plus 0.01 of the global aux. The metrics
    are global: "ce" the mean over the whole batch."""
    check_mesh(mesh)
    n_dp = 1 if mesh is None else mesh.size(("pod", "data"))

    def loss_fn(params, images, labels):
        logits, aux, z = swin_forward(params, images, cfg, pcfg, mesh,
                                      moe_impl=moe_impl)
        logp = torch.log_softmax(logits, dim=-1)
        ce = -logp.gather(-1, labels.long()[:, None]).mean()
        total = ce / n_dp + AUX_WEIGHT * aux
        if mesh is not None:
            ce = mesh.all_reduce(ce.detach(), ("pod", "data")) / n_dp
        return total, {"ce": ce, "aux_loss": aux, "z_loss": z}

    return loss_fn


def make_train_step(cfg: SwinConfig, pcfg: ParallelConfig,
                    opt_cfg: adamw.OptimizerConfig, *,
                    moe_impl: str = "hexa", mesh=None):
    """One AdamW step of Swin-MoE (``benchmarks/memory_table.py``'s
    ``make_train_fn``, which uses ``OptimizerConfig(master_fp32=False)``
    and takes ``moe_impl`` the same way).
    ``train_step(params, opt_state, images, labels) -> (params, opt_state,
    metrics)``; params and opt_state are updated in place
    (``adamw.apply_updates``) and metrics are 0-d tensors on the device
    ("loss" is ce + 0.01 aux). The update runs under the profiler range
    ``train_step.adamw``.

    On a ``mesh``, params and opt_state hold this rank's shards
    (``param_specs``; ``convert.shard_params``/``shard_opt_state`` cut
    them) and images/labels its ("pod", "data") group's rows. The MoE
    leaves' gradients come out of ``moe_layer`` as the global gradient's
    blocks; the dense leaves' are summed over ("pod", "data") only (the
    "model" ranks of a group hold the same rows and the same gradient).
    The clip norm is the global tree's (``_mesh_grad_norm``), and the
    moments follow the parameters' shards."""
    loss_fn = make_loss_fn(cfg, pcfg, moe_impl=moe_impl, mesh=mesh)
    moe_axes = None if mesh is None else _moe_leaf_axes(cfg, pcfg, mesh)

    def train_step(params, opt_state, images, labels):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        total, metrics = loss_fn(params, images, labels)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        it = iter(grads)
        grad_tree = tree_map(lambda _: next(it), params)
        del grads
        gnorm = None
        if mesh is not None:
            with record_function("train_step.grad_sync"):
                _sync_dense_grads(grad_tree, mesh)
                gnorm = _mesh_grad_norm(grad_tree, moe_axes, mesh)
        with record_function("train_step.adamw"):
            params, opt_state, om = adamw.apply_updates(
                params, grad_tree, opt_state, opt_cfg, grad_norm=gnorm)
        metrics = {k: v.detach() for k, v in metrics.items()}
        loss = (total.detach() if mesh is None
                else metrics["ce"] + AUX_WEIGHT * metrics["aux_loss"])
        return params, opt_state, {**metrics, **om, "loss": loss}

    return train_step


def _dense_leaves(tree):
    """The leaves outside the MoE blocks, in ``tree_leaves`` order."""
    out = []
    for st in tree["stages"]:
        for blk in st["blocks"]:
            out.extend(tree_leaves({k: v for k, v in blk.items()
                                    if k != "moe"}))
        out.extend(tree_leaves({k: v for k, v in st.items()
                                if k != "blocks"}))
    out.extend(tree_leaves({k: v for k, v in tree.items() if k != "stages"}))
    return out


def _sync_dense_grads(grads, mesh) -> None:
    """Sum the dense leaves' gradients over ("pod", "data"), in place, in
    one all-reduce of their concatenation."""
    dense = _dense_leaves(grads)
    flat = mesh.all_reduce(torch.cat([g.reshape(-1) for g in dense]),
                           ("pod", "data"))
    off = 0
    for g in dense:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


def _mesh_grad_norm(grads, moe_axes, mesh) -> torch.Tensor:
    """The global gradient tree's norm from this rank's blocks: each MoE
    leaf's sum of squares summed over the axes it is sharded on (once per
    group of leaves sharded alike); the dense leaves, replicated, count
    once."""
    dense = _dense_leaves(grads)
    total = torch.stack([torch.sum(torch.square(g.float()))
                         for g in dense]).sum()
    by_axes = {}
    for s, st in enumerate(grads["stages"]):
        for blk in st["blocks"]:
            for name, g in blk.get("moe", {}).items():
                axes = moe_axes[s][name]
                by_axes.setdefault(axes, []).append(
                    torch.sum(torch.square(g.float())))
    for axes, sq in sorted(by_axes.items()):
        total = total + mesh.all_reduce(torch.stack(sq).sum(), axes)
    return torch.sqrt(total)


def synthetic_batch(cfg: SwinConfig, batch_size: int, *,
                    generator: torch.Generator, device=None):
    """(images (B, H, W, C) f32 standard normal, labels (B,) int64) drawn
    from ``generator`` on ``device`` (the GPU unless given): no dataset."""
    device = resolve_device(device)
    images = torch.randn((batch_size, cfg.img_size, cfg.img_size,
                          cfg.in_chans), generator=generator, device=device)
    labels = torch.randint(0, cfg.num_classes, (batch_size,),
                           generator=generator, device=device)
    return images, labels
