"""LM assembly (counterpart of ``repro.models.lm``): parameter init, the
dense and the paged serving caches, and the forward pass (training, and
dense and paged serving).

The layer stack is a Python list of per-layer parameter dicts and the
forward an unrolled loop over it (the JAX package stacks layers per period
for ``lax.scan``; ``convert.params_from_jax`` unstacks them). The caches
are per-layer lists too: the JAX dense cache's leaf ``[pos][name][j]``
(period position ``pos``, period ``j``) is layer ``j * period + pos``
here. A layer's mixer is attention, Mamba, mLSTM or sLSTM; its FFN a
GLU-expert MoE, a dense GLU or MLP, an sLSTM block's small GLU, or none
(mLSTM blocks). Attention layers of a ``cross_attn`` config also attend
to a conditioning sequence (``inputs["cond"]``) after the mixer.
Recurrent layers keep per-slot state in both caches; only attention
layers have K/V rows or pages. The input is token embeddings, SigLIP
patches projected and put before them (``inputs["patches"]``), or
projected EnCodec frames (``inputs["embeds"]``); the head is the
vocabulary projection or, with ``num_codebooks > 1``, one per codebook.
Every LM configuration trains and takes the dense steps, MLP experts in
an LM stack (``glu=False`` with ``moe``: ``moe_mlp``) included; the
serving engines take token prompts and one head (``check_servable``), so
paligemma-3b serves as text, as the JAX engines serve it.

On a mesh (``forward(..., mesh=, x_spec=)``) each rank holds its blocks
of the parameters (``param_specs``, the JAX package's ``Param`` tags;
``convert.shard_params`` cuts them) and of the batch dimension with the
whole token sequence. The embedding is vocabulary-parallel over "tp"
(each rank looks up the ids of its own vocabulary block, zeros for the
others, ids outside the vocabulary clamped as JAX's gathers clamp them),
its partial sums reduce-scattered over the sequence straight to the
activations' (dp, sp, None); the layers run as ``models.transformer``'s
islands and ``moe_parallel.moe_layer``; the serving logits are gathered
whole on every rank. The dense cache holds this rank's slots (and K/V
heads where they split over "tp", a Mamba layer's state channels where
it splits them). Every layer kind runs there as an island: attention,
cross-attention, dense and MoE FFNs (``models.transformer``), Mamba
(``models.mamba``), mLSTM and sLSTM (``models.xlstm``); frontend inputs
are projected on every TP rank alike and the codebook heads are
vocabulary-parallel as the head is. A "node" axis runs the MoE islands'
hierarchical schedule, and ``overlap_dispatch`` the overlap schedule in
``run_layers``. The paged cache on a mesh (``paged_cache_specs``) keeps
every page on every rank with this rank's K/V heads, the slots' lengths
whole, and the recurrent state cut as the dense cache cuts it;
``check_mesh`` says what stays refused.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.common import torch_dtype, tree_map
from repro_torch.configs.base import ModelConfig
from repro_torch.models import frontends, mamba, transformer as tfm, xlstm
from repro_torch.obs import device as obs_device
from repro_torch.parallel.moe_parallel import (
    EP_NODE_REFUSAL,
    EP_PARAM_LOGICAL,
    MOE_PARAM_LOGICAL,
    _Gather,
    _Psum,
)
from repro_torch.parallel.sharding import (
    ParallelConfig,
    as_axes,
    gather_blocks,
    normal_init,
    physical_spec,
)

#: The pipeline-shared cache's ``stats()`` of the last forward that built
#: one (``run_layers``); None until then. Tests and the card's smoke run
#: read it after a call.
LAST_PIPELINE_CACHE_STATS: Optional[dict] = None

#: Logical specs of the embedding table, the vocabulary head and the
#: codebook heads (each vocabulary-parallel).
EMBED_LOGICAL = ("tp", "fsdp")
HEAD_LOGICAL = ("fsdp", "tp")
CB_HEADS_LOGICAL = (None, "fsdp", "tp")


def check_servable(cfg: ModelConfig) -> None:
    """Raise for a configuration the serving engines do not take: EnCodec
    frames or codebook heads (musicgen-large). The engines' prompts are
    token ids and their sampler draws one token a row, as the JAX
    engines' are and do: a siglip config serves its token prompts with no
    image prefix. The dense steps (``make_prefill_step``/
    ``make_serve_step``) take every configuration."""
    if cfg.frontend == "encodec" or cfg.num_codebooks > 1:
        raise NotImplementedError(
            f"{cfg.name}: the serving engines take token prompts and one "
            f"vocabulary head, as the JAX package's do; EnCodec frames and "
            f"codebook heads are served by neither")


def check_mesh(cfg: ModelConfig, pcfg: ParallelConfig, mesh) -> None:
    """Raise for what the port does not run on a mesh: the "ep" mode on a
    two-level "node" mesh, as the JAX package refuses it."""
    if mesh is None:
        return
    if pcfg.mode == "ep" and cfg.moe is not None \
            and "node" in mesh.axis_names:
        raise NotImplementedError(EP_NODE_REFUSAL)


def recurrent_layers(cfg: ModelConfig) -> list:
    """Indices of the layers whose mixer keeps per-slot recurrent state
    (every layer but the attention ones); empty for an all-attention
    stack."""
    return [i for i in range(cfg.num_layers) if cfg.layer_kind(i) != "attn"]


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _ffn_kind(cfg: ModelConfig, idx: int) -> Optional[str]:
    kind = cfg.layer_kind(idx)
    if kind == "slstm":
        return "slstm_ffn"
    if kind == "mlstm":
        return None
    if cfg.is_moe_layer(idx):
        return "moe"
    if cfg.d_ff > 0:
        return "dense"
    return None


_MIXER_INIT = {"attn": tfm.init_attention, "mamba": mamba.init_mamba,
               "mlstm": xlstm.init_mlstm, "slstm": xlstm.init_slstm}


def init_block(cfg: ModelConfig, idx: int, dtype, generator, device,
               quant: Optional[str] = None, plan=None) -> dict:
    """Layer ``idx``'s parameters: its mixer, its cross-attention (attention
    layers of a ``cross_attn`` config), then its FFN (none on mLSTM
    layers; an sLSTM block's GLU of width ``ceil64(ffn_factor * d)``).
    ``quant``: the MoE experts quantized as drawn; ``plan``: a
    ``core.hetero.HeteroPlan`` padding their hidden width
    (``init_moe_ffn``)."""
    kind = cfg.layer_kind(idx)
    p = {"ln1": tfm.init_norm(cfg, device),
         "mixer": _MIXER_INIT[kind](cfg, dtype, generator, device)}
    if cfg.cross_attn and kind == "attn":
        p["ln_x"] = tfm.init_norm(cfg, device)
        p["xattn"] = tfm.init_cross_attention(cfg, dtype, generator, device)
    fk = _ffn_kind(cfg, idx)
    if fk is not None:
        p["ln2"] = tfm.init_norm(cfg, device)
    if fk == "moe":
        p["ffn"] = tfm.init_moe_ffn(cfg, dtype, generator, device,
                                    quant=quant, plan=plan)
    elif fk == "dense":
        p["ffn"] = tfm.init_dense_ffn(cfg, dtype, generator, device)
    elif fk == "slstm_ffn":
        f = int(cfg.xlstm.ffn_factor * cfg.d_model)
        p["ffn"] = tfm.init_dense_ffn(cfg, dtype, generator, device,
                                      d_ff=(f + 63) // 64 * 64, glu=True)
    return p


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device, quant: Optional[str] = None, plan=None) -> dict:
    """Full parameter tree, drawn from ``generator`` (on ``device``): the
    JAX package's shapes and its 0.02-std normal, not its numbers.
    ``quant`` ("int8" | "fp8"): each expert matrix is quantized
    (``quant.core.quantize_blockwise``, expert by expert) as soon as it is
    drawn and its full-precision copy freed, so the full-precision tree
    never exists; the weights equal ``quantize_lm_params`` of the tree
    drawn without it. ``plan``: a ``core.hetero.HeteroPlan`` whose uneven
    Eq. 2 hidden splits pad every MoE FFN (``tfm.init_moe_ffn``)."""
    dtype = torch_dtype(cfg.dtype)
    p = {
        "embed": normal_init((cfg.vocab_size, cfg.d_model), dtype, generator,
                             device),
        "final_norm": tfm.init_norm(cfg, device),
        "layers": [init_block(cfg, i, dtype, generator, device, quant=quant,
                              plan=plan)
                   for i in range(cfg.num_layers)],
    }
    if not cfg.tie_embeddings:
        p["head"] = normal_init((cfg.d_model, cfg.vocab_size), dtype,
                                generator, device)
    if cfg.num_codebooks > 1:
        p["cb_heads"] = normal_init(
            (cfg.num_codebooks, cfg.d_model, cfg.vocab_size), dtype,
            generator, device)
    if cfg.frontend:
        p["frontend"] = frontends.init_frontend(cfg, dtype, generator, device)
    return p


def param_shapes(cfg: ModelConfig, plan=None) -> dict:
    """Every leaf's global shape, in ``init_params``' tree structure."""
    p = init_params(cfg, generator=torch.Generator(), device="meta",
                    plan=plan)
    return tree_map(lambda t: tuple(t.shape), p)


def param_specs(cfg: ModelConfig, pcfg: ParallelConfig) -> dict:
    """Logical spec of every leaf, in ``init_params``' tree structure (the
    JAX package's ``Param`` tags, per layer here): the embedding ("tp",
    "fsdp"), the head ("fsdp", "tp"), attention and dense FFN weights as
    ``models.transformer``'s tables, the MoE FFN as ``moe_parallel``
    places it under ``pcfg.mode``, the recurrent mixers,
    cross-attention and frontend projection as their modules' tables,
    the codebook heads ``CB_HEADS_LOGICAL``, the norms replicated."""
    moe = EP_PARAM_LOGICAL if pcfg.mode == "ep" else MOE_PARAM_LOGICAL
    shapes = param_shapes(cfg, plan=pcfg.hetero_plan)

    def table(name: str, idx: int) -> dict:
        if name in ("ln1", "ln2", "ln_x"):
            return tfm.NORM_LOGICAL
        if name == "mixer":
            return _MIXER_LOGICAL[cfg.layer_kind(idx)]
        if name == "xattn":
            return tfm.XATTN_LOGICAL
        if name == "ffn":
            return moe if _ffn_kind(cfg, idx) == "moe" else \
                tfm.DENSE_FFN_LOGICAL
        return {}

    def leaves(sub: dict, tbl: dict) -> dict:
        return {k: tbl.get(k, (None,) * len(shape)) for k, shape in
                sub.items()}

    out = {"layers": [{k: leaves(v, table(k, i)) for k, v in lp.items()}
                      for i, lp in enumerate(shapes["layers"])],
           "embed": EMBED_LOGICAL,
           "final_norm": leaves(shapes["final_norm"], tfm.NORM_LOGICAL)}
    if "head" in shapes:
        out["head"] = HEAD_LOGICAL
    if "cb_heads" in shapes:
        out["cb_heads"] = CB_HEADS_LOGICAL
    if "frontend" in shapes:
        out["frontend"] = leaves(shapes["frontend"],
                                 frontends.FRONTEND_LOGICAL)
    return out


_MIXER_LOGICAL = {"attn": tfm.ATTN_LOGICAL, "mamba": mamba.MAMBA_LOGICAL,
                  "mlstm": xlstm.MLSTM_LOGICAL, "slstm": xlstm.SLSTM_LOGICAL}


def physical_specs(cfg: ModelConfig, pcfg: ParallelConfig, mesh) -> dict:
    """Every leaf's physical spec on ``mesh`` (``param_specs`` placed at
    the leaf's global shape), in the parameter tree's structure."""
    return tree_map(lambda lg, shape: physical_spec(shape, lg, pcfg, mesh),
                    param_specs(cfg, pcfg),
                    param_shapes(cfg, plan=pcfg.hetero_plan))


def _state_spec(cfg: ModelConfig, idx: int, batch: int, dtype) -> dict:
    """Per-slot recurrent state of a non-attention layer."""
    kind = cfg.layer_kind(idx)
    if kind == "mamba":
        return mamba.cache_spec_mamba(cfg, batch, dtype)
    if kind == "mlstm":
        return xlstm.cache_spec_mlstm(cfg, batch, dtype)
    return xlstm.cache_spec_slstm(cfg, batch)


# ---------------------------------------------------------------------------
# dense serving cache
# ---------------------------------------------------------------------------

def cache_spec(cfg: ModelConfig, batch: int, seq_len: int) -> dict:
    """Shapes and dtypes of the dense decode cache: per attention layer K
    and V ``(batch, S_cache, Hkv, hd)`` (``S_cache = min(seq_len, window)``
    on windowed layers), per recurrent layer its state, and the per-slot
    filled length."""
    dtype = torch_dtype(cfg.dtype)
    rec = recurrent_layers(cfg)
    return {"layers": [
        _state_spec(cfg, i, batch, dtype) if i in rec
        else tfm.cache_spec_attention(cfg, i, batch, seq_len, dtype)
        for i in range(cfg.num_layers)],
        "len": ((batch,), torch.int32)}


def _zeros_like_spec(spec: dict, device) -> dict:
    zeros = lambda sd: torch.zeros(sd[0], dtype=sd[1], device=device)  # noqa: E731
    return {"layers": [{k: zeros(sd) for k, sd in layer.items()}
                       for layer in spec["layers"]],
            "len": zeros(spec["len"])}


def init_cache(cfg: ModelConfig, batch: int, seq_len: int, device, *,
               pcfg: Optional[ParallelConfig] = None, mesh=None) -> dict:
    """The dense ``(batch, seq_len)`` KV rectangle, zeroed, on ``device``.
    On a ``mesh``: this rank's block of it (``cache_specs``)."""
    if mesh is None:
        return _zeros_like_spec(cache_spec(cfg, batch, seq_len), device)
    specs = cache_specs(cfg, pcfg, mesh, batch, seq_len)
    spec = cache_spec(cfg, batch, seq_len)

    def local(sd, ps):
        shape = [n // mesh.size(a) for n, a in zip(sd[0], ps)]
        return (tuple(shape), sd[1])

    return _zeros_like_spec(tree_map(local, spec, specs), device)


def cache_specs(cfg: ModelConfig, pcfg: ParallelConfig, mesh, batch: int,
                seq_len: int) -> dict:
    """Physical specs of the dense cache's leaves on ``mesh``, in its tree
    structure: the slots split as the decode step's batch is
    (``launch.inputs.activation_spec`` of (batch, 1, d_model)), the K/V
    heads over "tp" where the heads split
    (``transformer.heads_shardable``), a Mamba layer's conv window and
    SSM state over "tp" in their channels where the layer splits them
    (``mamba.mesh_split``), the xLSTM states whole on every TP rank."""
    from repro_torch.launch.inputs import activation_spec

    check_mesh(cfg, pcfg, mesh)
    baxes = activation_spec((batch, 1, cfg.d_model), pcfg, mesh)[0]
    tp = pcfg.axes(mesh)["tp"]
    heads = tp if tfm.heads_shardable(cfg, mesh.size(tp)) else None
    chans = tp if mamba.mesh_split(cfg, pcfg, mesh) else None
    spec = cache_spec(cfg, batch, seq_len)

    def layer_specs(i: int, layer: dict) -> dict:
        kind = cfg.layer_kind(i)
        if kind == "attn":
            return {k: (baxes, None, heads, None) for k in layer}
        if kind == "mamba":
            return {"conv": (baxes, None, chans), "ssm": (baxes, chans, None)}
        return {k: (baxes,) + (None,) * (len(sd[0]) - 1)
                for k, sd in layer.items()}

    return {"layers": [layer_specs(i, layer)
                       for i, layer in enumerate(spec["layers"])],
            "len": (baxes,)}


def gather_cache(cache: dict, specs: dict, mesh) -> dict:
    """The whole dense cache from every rank's block (collective)."""
    return tree_map(lambda t, sp: gather_blocks(t, sp, mesh), cache, specs)


def cache_bytes(cache: dict) -> int:
    """Device bytes of a cache's K/V (and scale) and recurrent-state
    tensors."""
    return sum(t.numel() * t.element_size()
               for layer in cache["layers"] for t in layer.values())


# ---------------------------------------------------------------------------
# paged serving cache
# ---------------------------------------------------------------------------

def _check_kv_quant(kv_quant: Optional[str]) -> bool:
    if kv_quant not in (None, "none", "int8"):
        raise ValueError(f"unsupported kv_quant {kv_quant!r}")
    return kv_quant == "int8"


def paged_cache_spec(cfg: ModelConfig, num_slots: int, num_pages: int,
                     page_size: int, kv_quant: Optional[str] = None) -> dict:
    """Shapes and dtypes of the paged decode cache: per attention layer a
    SHARED pool of ``num_pages`` pages, ``(num_pages, page_size, Hkv, hd)``
    for K and for V (physical page 0 is the write sink for inactive slots),
    and the per-slot resident length. ``kv_quant="int8"``: int8 pools plus
    f32 ``k_scale``/``v_scale`` pools ``(num_pages, page_size, Hkv)`` of
    per-(row, kv head) scales. Recurrent layers keep their per-slot state
    ``(num_slots, ...)`` as in ``cache_spec``: there is nothing to page."""
    quant = _check_kv_quant(kv_quant)
    dtype = torch_dtype(cfg.dtype)
    shape = (num_pages, page_size, cfg.num_kv_heads, cfg.hd)
    pool = (shape, torch.int8 if quant else dtype)
    entry = {"k": pool, "v": pool}
    if quant:
        entry["k_scale"] = entry["v_scale"] = (shape[:3], torch.float32)
    rec = recurrent_layers(cfg)
    return {"layers": [
        _state_spec(cfg, i, num_slots, dtype) if i in rec
        else dict(entry) for i in range(cfg.num_layers)],
        "len": ((num_slots,), torch.int32)}


def paged_cache_logical_specs(cfg: ModelConfig, cache: dict) -> dict:
    """The JAX package's logical specs of the paged cache, layer by layer
    (its tree per period position without the leading period axis): the
    pools' page dimension over "dp", the recurrent state's slots over
    "dp" (Mamba's and the mLSTM's conv channels, Mamba's SSM channels
    over "tp"), the lengths over "dp". JAX's engine never applies them,
    and neither does the port: pages over "dp" would need every read of a
    slot's pages gathered across ranks, since the pool hands out any page
    to any slot. The port places the cache by ``paged_cache_specs``."""
    layers = []
    for i, layer in enumerate(cache["layers"]):
        kind = cfg.layer_kind(i)
        if kind == "attn":
            spec = {"k": ("dp", None, None, None),
                    "v": ("dp", None, None, None)}
            if "k_scale" in layer:
                spec["k_scale"] = spec["v_scale"] = ("dp", None, None)
        elif kind == "mamba":
            spec = {"conv": ("dp", None, "tp"), "ssm": ("dp", "tp", None)}
        elif kind == "mlstm":
            spec = {"c": ("dp", None, None, None), "n": ("dp", None, None),
                    "m": ("dp", None), "conv": ("dp", None, "tp")}
        else:
            spec = {k: ("dp", None, None) for k in ("c", "n", "h", "m")}
        layers.append(spec)
    return {"layers": layers, "len": ("dp",)}


def paged_slot_block(cfg: ModelConfig, pcfg: ParallelConfig, mesh,
                     num_slots: int) -> tuple:
    """(axes, lo, n): the mesh axes the paged engine's slots split over
    (the decode step's batch, ``launch.inputs.activation_spec`` of
    (num_slots, 1, d_model)) and this rank's slots ``[lo, lo + n)``;
    ((), 0, num_slots) without a mesh."""
    if mesh is None:
        return (), 0, num_slots
    from repro_torch.launch.inputs import activation_spec

    axes = as_axes(activation_spec((num_slots, 1, cfg.d_model), pcfg,
                                   mesh)[0])
    n = num_slots // mesh.size(axes)
    return axes, mesh.index(axes) * n, n


def paged_cache_specs(cfg: ModelConfig, pcfg: ParallelConfig, mesh,
                      num_slots: int, num_pages: int, page_size: int,
                      kv_quant: Optional[str] = None) -> dict:
    """Physical specs of the paged cache's leaves on ``mesh``, in its tree
    structure. Every page lies on every rank, so the host ``PagePool``
    keeps its global page ids and any slot reads any page where it runs:
    each written K/V row (with its int8 scale) goes to every rank's pool
    (``models.transformer``'s paged branches gather the rows over the
    slots' axes before the write). The pools hold this rank's K/V heads
    where the heads split over "tp" (``transformer.heads_shardable``), all
    of them otherwise (MQA). The recurrent state is cut as the dense
    cache cuts it (``cache_specs``: the slots over their axes, Mamba's
    channels over "tp"); the lengths are whole on every rank."""
    check_mesh(cfg, pcfg, mesh)
    baxes = paged_slot_block(cfg, pcfg, mesh, num_slots)[0] or None
    tp = pcfg.axes(mesh)["tp"]
    heads = tp if tfm.heads_shardable(cfg, mesh.size(tp)) else None
    chans = tp if mamba.mesh_split(cfg, pcfg, mesh) else None
    spec = paged_cache_spec(cfg, num_slots, num_pages, page_size, kv_quant)

    def layer_specs(i: int, layer: dict) -> dict:
        kind = cfg.layer_kind(i)
        if kind == "attn":
            return {k: (None, None, heads) + (None,) * (len(sd[0]) - 3)
                    for k, sd in layer.items()}
        if kind == "mamba":
            return {"conv": (baxes, None, chans), "ssm": (baxes, chans, None)}
        return {k: (baxes,) + (None,) * (len(sd[0]) - 1)
                for k, sd in layer.items()}

    return {"layers": [layer_specs(i, layer)
                       for i, layer in enumerate(spec["layers"])],
            "len": (None,)}


def init_paged_cache(cfg: ModelConfig, num_slots: int, num_pages: int,
                     page_size: int, device,
                     kv_quant: Optional[str] = None, *,
                     pcfg: Optional[ParallelConfig] = None,
                     mesh=None) -> dict:
    """The paged cache, zeroed, on ``device``; on a ``mesh``, this rank's
    block of it (``paged_cache_specs``)."""
    spec = paged_cache_spec(cfg, num_slots, num_pages, page_size, kv_quant)
    if mesh is not None:
        specs = paged_cache_specs(cfg, pcfg, mesh, num_slots, num_pages,
                                  page_size, kv_quant)
        spec = tree_map(lambda sd, ps: (tuple(
            n // mesh.size(a) for n, a in zip(sd[0], ps)), sd[1]),
            spec, specs)
    return _zeros_like_spec(spec, device)


def paged_kv_page_bytes(cfg: ModelConfig, page_size: int,
                        kv_quant: Optional[str] = None) -> int:
    """Device bytes ONE physical page costs across every attention layer —
    the unit ``parallel.cache.PagePool`` budgets admission in. With
    ``kv_quant="int8"`` a K or V row costs ``Hkv * (hd + 4)`` bytes: the
    int8 payload and one f32 scale per kv head."""
    n_attn = sum(cfg.layer_kind(i) == "attn" for i in range(cfg.num_layers))
    itemsize = torch.empty((), dtype=torch_dtype(cfg.dtype)).element_size()
    row = cfg.num_kv_heads * cfg.hd * itemsize
    if _check_kv_quant(kv_quant):
        row = cfg.num_kv_heads * (cfg.hd + 4)
    return n_attn * 2 * page_size * row


def reset_slot(cfg: ModelConfig, cache: dict, slot: int,
               length: int = 0, *, held: Optional[tuple] = None) -> dict:
    """Reset one slot so a new request can reuse it (in place): its length
    to ``length`` and its recurrent state rows to zero. K/V needs no
    scrub: the dense buffer and freshly granted pages are both masked by
    ``len``. ``length > 0`` (prefix-sharing admission) only on
    all-attention stacks: recurrent state has no paged representation.
    ``held``: (lo, n), the slots ``[lo, lo + n)`` whose state rows the
    cache holds, at rows ``slot - lo`` (a paged cache on a mesh, whose
    lengths are whole); default every slot."""
    recurrent = recurrent_layers(cfg)
    if length and recurrent:
        raise ValueError(
            "prefix-sharing reset (length > 0) requires an all-attention "
            "stack: recurrent per-slot state has no paged representation")
    lo, n = held if held is not None else (0, cache["len"].shape[0])
    if lo <= slot < lo + n:
        for i in recurrent:
            for t in cache["layers"][i].values():
                t[slot - lo].zero_()
    cache["len"][slot] = length
    return cache


def rollback_slot(cfg: ModelConfig, cache: dict, slot: int,
                  length: int) -> dict:
    """Truncate one slot's resident length to ``length`` (in place), the
    device half of speculative-decoding rollback. Rejected drafted rows
    need no scrub: paged attention masks every position at and past the
    length, as it masks a fresh page's tail. Only an all-attention stack
    can rewind this way: a recurrent mixer's per-slot state advances token
    by token and cannot be truncated."""
    if recurrent_layers(cfg):
        raise ValueError(
            "rollback (length truncation) requires an all-attention "
            "stack: recurrent per-slot state cannot be rewound")
    if length < 0:
        raise ValueError(f"negative rollback length {length}")
    cache["len"][slot] = length
    return cache


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------

def apply_block(p: dict, x: torch.Tensor, ctx: tfm.Ctx, idx: int,
                cache: Optional[dict], gathered: Optional[tuple] = None):
    """One block: mixer, cross-attention where the layer has it, then the
    FFN where the layer has one. Returns
    (x, cache, aux, z, stats): ``stats`` the MoE layer's router stats when
    ``ctx.pcfg.collect_router_stats`` is set and the block holds an MoE
    FFN, else None. In a decode macro-step with an ``active`` mask,
    inactive slots keep their recurrent state (attention writes its own
    sink row). ``gathered``: the MoE FFN's expert weights from the
    pipeline-shared cache and the collectives that gathered them
    ("fsdp" or "all"; ``run_layers``)."""
    kind = ctx.cfg.layer_kind(idx)
    h = tfm.block_norm(p["ln1"], x, ctx)
    if kind == "attn":
        out, new_cache = tfm.apply_attention(p["mixer"], h, ctx, idx, cache)
    else:
        out, new_cache = _RECURRENT_APPLY[kind](p["mixer"], h, ctx, cache)
        if (ctx.mode == "decode" and ctx.decode_active is not None
                and cache is not None):
            act = ctx.decode_active
            new_cache = {k: torch.where(
                act.reshape((-1,) + (1,) * (v.ndim - 1)), v, cache[k])
                for k, v in new_cache.items()}
    x = x + out
    if "xattn" in p:
        x = x + tfm.apply_cross_attention(
            p["xattn"], tfm.block_norm(p["ln_x"], x, ctx), ctx)
    aux = z = torch.zeros((), dtype=torch.float32, device=x.device)
    stats = None
    if "ffn" in p:
        h2 = tfm.block_norm(p["ln2"], x, ctx)
        if ctx.cfg.is_moe_layer(idx):
            out = tfm.apply_moe_ffn(p["ffn"], h2, ctx, idx % ctx.cfg.period,
                                    gathered)
            y, aux, z = out[:3]
            if ctx.pcfg.collect_router_stats:
                stats = out[3]
        else:
            y = tfm.apply_dense_ffn(p["ffn"], h2, ctx)
        x = x + y
    return x, new_cache, aux, z, stats


_RECURRENT_APPLY = {"mamba": mamba.apply_mamba, "mlstm": xlstm.apply_mlstm,
                    "slstm": xlstm.apply_slstm}


def _train_block(p: dict, x: torch.Tensor, ctx: tfm.Ctx, idx: int):
    x, _, aux, z, stats = apply_block(p, x, ctx, idx, None)
    return x, aux, z, stats


def run_layers(layers: list, x: torch.Tensor, ctx: tfm.Ctx,
               cache_layers: list):
    """The unrolled layer loop. Returns (x, aux, z, cache_layers, stats):
    ``stats`` the router stats summed over every MoE layer
    (``obs.add_stats``) when ``pcfg.collect_router_stats`` is set and the
    stack has MoE layers, else None.

    A training forward with ``pcfg.remat == "block"`` checkpoints each
    block (``torch.utils.checkpoint``, non-reentrant): only its input is
    saved and its forward, kernels included, runs again in the backward,
    as the JAX package's ``jax.checkpoint`` of a period does.

    ``pcfg.cache_layers > 0`` runs the pipeline-shared prefetch cache
    (``parallel.cache.PipelineSharedCache``) where the JAX package's
    unrolled loop runs it: a stack with MoE layers, outside the "ep" mode
    and outside the remat'd training forward (whose checkpoints would
    save every gathered layer; there the cache policy is the cache). One
    entry is one MoE layer's expert weights with their fsdp factor
    gathered (``gather_ffn_params``), fetched before the layer computes,
    with the next MoE layer's gather issued first when the capacity is 2
    or more; ``moe_layer(pregathered=True)`` takes them. JAX keys an entry
    by period, the port by layer: the same for a period-1 stack. The
    cache's ``stats()`` go to ``LAST_PIPELINE_CACHE_STATS``.

    ``pcfg.overlap_dispatch`` in the "auto" mode (the overlap schedule):
    each MoE layer's dispatch is resolved once, with the island's own
    chooser (``moe_parallel._auto_layer_mode``); a data-centric layer's
    entry is its whole expert weights (``gather_ffn_params(collectives=
    "all")``), so the next layer's TP gather is issued before this layer
    computes too, and the island skips its own (``pregathered="all"``).
    The values are the eager schedule's, bit for bit."""
    global LAST_PIPELINE_CACHE_STATS
    cfg, pcfg = ctx.cfg, ctx.pcfg
    remat = ctx.mode == "train" and pcfg.remat != "none"
    moe_idx = [i for i in range(len(layers)) if _ffn_kind(cfg, i) == "moe"]
    pcache = None
    if pcfg.cache_layers > 0 and moe_idx and pcfg.mode != "ep" \
            and not remat:
        from repro_torch.parallel.cache import (
            PipelineSharedCache,
            gather_ffn_params,
        )

        pcache = PipelineSharedCache(pcfg.cache_layers)
        ms = tfm.moe_static(cfg, pcfg)
        levels = dict.fromkeys(moe_idx, "fsdp")
        if pcfg.overlap_dispatch and pcfg.mode == "auto":
            # the overlap schedule: each MoE layer's level resolved once
            # with the island's own chooser, so an "all"-gathered layer is
            # exactly one the island would run data-centric
            from repro_torch.parallel.moe_parallel import _auto_layer_mode

            tokens = x.shape[0] * x.shape[1]
            if ctx.mesh is not None:
                tokens *= ctx.mesh.size(as_axes(ctx.x_spec[0])) \
                    * ctx.mesh.size(as_axes(ctx.x_spec[1]))
            for i in moe_idx:
                if _auto_layer_mode(ms, cfg.d_model, pcfg, ctx.mesh, tokens,
                                    i % cfg.period) == "data_centric":
                    levels[i] = "all"

        def gather(i):
            g = gather_ffn_params(layers[i]["ffn"], pcfg, ctx.mesh,
                                  d_ff=ms.d_ff, collectives=levels[i])
            return g, levels[i]

    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    z = torch.zeros((), dtype=torch.float32, device=x.device)
    stats = (obs_device.zero_stats(cfg.moe.num_experts, x.device)
             if pcfg.collect_router_stats and cfg.moe is not None else None)
    new_caches = []
    for idx, (lp, lc) in enumerate(zip(layers, cache_layers)):
        g = None
        if pcache is not None and idx in moe_idx:
            g = pcache.fetch(idx, lambda: gather(idx))
            later = [i for i in moe_idx if i > idx]
            if pcache.capacity_layers >= 2 and later:
                # double buffer: issue the next MoE layer's gather before
                # this layer computes
                pcache.prefetch(later[0], lambda: gather(later[0]))
        if remat:
            x, a, zz, st = checkpoint(_train_block, lp, x, ctx, idx,
                                      use_reentrant=False)
            nc = lc
        else:
            x, nc, a, zz, st = apply_block(lp, x, ctx, idx, lc, gathered=g)
        new_caches.append(nc)
        aux = aux + a
        z = z + zz
        if stats is not None and st is not None:
            stats = obs_device.add_stats(stats, st)
    if pcache is not None:
        LAST_PIPELINE_CACHE_STATS = pcache.stats()
    return x, aux, z, new_caches, stats


def _embed_in(params: dict, inputs: dict, cfg: ModelConfig, dtype):
    """The first hidden states: SigLIP patches projected, then the token
    embeddings after them (``patches`` given); projected EnCodec frames
    (``embeds``); else the token embeddings. Scaled by ``sqrt(d_model)``
    rounded to ``dtype`` where the config says so."""
    if cfg.frontend == "siglip" and "patches" in inputs:
        patches = frontends.project_frontend(params["frontend"],
                                             inputs["patches"], dtype)
        x_txt = params["embed"][inputs["tokens"].long()].to(dtype)
        x = torch.cat([patches, x_txt], dim=1)
    elif cfg.frontend == "encodec":
        x = frontends.project_frontend(params["frontend"], inputs["embeds"],
                                       dtype)
    else:
        x = params["embed"][inputs["tokens"].long()].to(dtype)
    if cfg.embed_scale:
        x = x * torch.tensor(math.sqrt(cfg.d_model), dtype=dtype)
    return x


def _embed_mesh(params: dict, inputs: dict, cfg: ModelConfig,
                ctx: tfm.Ctx, dtype) -> torch.Tensor:
    """The first hidden states on a mesh (an island): this rank's batch
    block of the inputs (the whole sequence) -> its block of the
    activations at ``ctx.x_spec``.

    Tokens: the vocabulary-parallel embedding. Ids are wrapped and
    clamped into the vocabulary as JAX's gathers do; each rank looks up
    those in its vocabulary block and gives zeros for the rest, and the
    partial sums are reduce-scattered over the sequence (all-reduced
    where the sequence is not split). A vocabulary "tp" does not divide
    leaves the table whole: then each rank keeps its own sequence block
    of the lookup. Frontend inputs: the projection (its fsdp factor
    gathered) on every rank of the TP group alike; SigLIP patches go
    before the token embeddings, summed whole over the vocabulary split
    first; each rank keeps its sequence block."""
    mesh, d = ctx.mesh, cfg.d_model
    seq_axes = as_axes(ctx.x_spec[1])
    scale = (torch.tensor(math.sqrt(d), dtype=dtype) if cfg.embed_scale
             else None)
    if cfg.frontend == "encodec":
        x = _frontend_mesh(params, inputs["embeds"], cfg, ctx, dtype)
        if scale is not None:
            x = x * scale
        return tfm.island_out(tfm.seq_take(x, mesh, seq_axes), mesh,
                              ctx.x_spec)
    x, vaxes = _vocab_lookup(params, inputs["tokens"], cfg, ctx, dtype)
    if cfg.frontend == "siglip" and "patches" in inputs:
        if vaxes:
            x = _Psum.apply(x, mesh, vaxes)
        x = torch.cat([_frontend_mesh(params, inputs["patches"], cfg, ctx,
                                      dtype), x], dim=1)
        if scale is not None:
            x = x * scale
        return tfm.island_out(tfm.seq_take(x, mesh, seq_axes), mesh,
                              ctx.x_spec)
    if scale is not None:
        x = x * scale
    if vaxes:
        # "sp" and "tp" are one mesh axis: summing the vocabulary blocks
        # scatters the sequence
        x = tfm.tp_reduce(x, mesh, seq_axes, vaxes)
    else:
        x = tfm.seq_take(x, mesh, seq_axes)
    return tfm.island_out(x, mesh, ctx.x_spec)


def _vocab_lookup(params: dict, tokens: torch.Tensor, cfg: ModelConfig,
                  ctx: tfm.Ctx, dtype):
    """This rank's partial embedding of ``tokens`` (B, S) from its
    vocabulary block (zeros for the ids it does not hold), and the mesh
    axes the vocabulary is split over (none: the whole lookup)."""
    mesh, v, d = ctx.mesh, cfg.vocab_size, cfg.d_model
    spec = physical_spec((v, d), EMBED_LOGICAL, ctx.pcfg, mesh)
    emb = tfm.weight_in(params["embed"], mesh, spec, EMBED_LOGICAL)
    ids = tokens.long()
    ids = torch.where(ids < 0, ids + v, ids).clamp(0, v - 1)
    vaxes = as_axes(spec[0])
    if not vaxes:
        return emb[ids].to(dtype), vaxes
    vl = emb.shape[0]
    local = ids - mesh.index(vaxes) * vl
    hit = (local >= 0) & (local < vl)
    x = torch.where(hit[..., None], emb[local.clamp(0, vl - 1)],
                    torch.zeros((), dtype=emb.dtype, device=emb.device))
    return x.to(dtype), vaxes


def _frontend_mesh(params: dict, feats: torch.Tensor, cfg: ModelConfig,
                   ctx: tfm.Ctx, dtype) -> torch.Tensor:
    """``frontends.project_frontend`` inside an island: the projection
    entered at its placement with its fsdp factor gathered."""
    p = params["frontend"]
    shape = (cfg.frontend_dim, cfg.d_model)
    logical = frontends.FRONTEND_LOGICAL["proj"]
    w = tfm.weight_in(p["proj"], ctx.mesh,
                      physical_spec(shape, logical, ctx.pcfg, ctx.mesh),
                      logical)
    return frontends.project_frontend({"proj": w}, feats, dtype)


def head_weight(params: dict, cfg: ModelConfig, pcfg: ParallelConfig,
                mesh):
    """The vocabulary head inside a mesh island: (D, V_l) with its fsdp
    factor gathered and its vocabulary block kept (the tied embedding
    transposed), and the mesh axes the vocabulary is split over."""
    v, d = cfg.vocab_size, cfg.d_model
    if cfg.tie_embeddings:
        spec = physical_spec((v, d), EMBED_LOGICAL, pcfg, mesh)
        w = tfm.weight_in(params["embed"], mesh, spec, EMBED_LOGICAL).t()
        return w, as_axes(spec[0])
    spec = physical_spec((d, v), HEAD_LOGICAL, pcfg, mesh)
    return (tfm.weight_in(params["head"], mesh, spec, HEAD_LOGICAL),
            as_axes(spec[1]))


def cb_head_weight(params: dict, cfg: ModelConfig, pcfg: ParallelConfig,
                   mesh):
    """The codebook heads inside a mesh island: (C, D, V_l) with the fsdp
    factor gathered and the vocabulary block kept, and the mesh axes the
    vocabulary is split over."""
    shape = (cfg.num_codebooks, cfg.d_model, cfg.vocab_size)
    spec = physical_spec(shape, CB_HEADS_LOGICAL, pcfg, mesh)
    return (tfm.weight_in(params["cb_heads"], mesh, spec, CB_HEADS_LOGICAL),
            as_axes(spec[2]))


def _logits_mesh(params: dict, x: torch.Tensor, cfg: ModelConfig,
                 pcfg: ParallelConfig, mesh, x_spec, last_only: bool):
    """Vocabulary logits f32 on a mesh: this rank's batch block, the whole
    sequence (or its last row) and the whole vocabulary, gathered over
    the sequence and the vocabulary split; (B, S, C, V) through the
    codebook heads."""
    x = tfm.seq_gather(tfm.island_in(x, mesh, x_spec), mesh,
                        as_axes(x_spec[1]))
    if last_only:
        x = x[:, -1:]
    if cfg.num_codebooks > 1:
        w, vaxes = cb_head_weight(params, cfg, pcfg, mesh)
        logits = torch.einsum("bsd,cdv->bscv", x.float(), w.float())
        spec = (x_spec[0], None, None, None)
    else:
        w, vaxes = head_weight(params, cfg, pcfg, mesh)
        logits = x.float() @ w.float()
        spec = (x_spec[0], None, None)
    if vaxes:
        logits = _Gather.apply(logits, mesh, vaxes, logits.ndim - 1)
    return tfm.island_out(logits, mesh, spec)


def _logits_out(params: dict, x: torch.Tensor, cfg: ModelConfig):
    """Vocabulary logits in f32 (the JAX head's f32 accumulation): (B, S,
    V), or (B, S, C, V) through the C codebook heads."""
    if cfg.num_codebooks > 1:
        return torch.einsum("bsd,cdv->bscv", x.float(),
                            params["cb_heads"].float())
    w = params["embed"].t() if cfg.tie_embeddings else params["head"]
    return x.float() @ w.float()


def head_logits(params: dict, hidden: torch.Tensor, cfg: ModelConfig,
                pcfg: Optional[ParallelConfig] = None, mesh=None,
                x_spec: Optional[tuple] = None) -> torch.Tensor:
    """Vocabulary logits f32 at every position of final-norm ``hidden``
    states (``forward(return_hidden=True)``'s); on a ``mesh``, of this
    rank's block at ``x_spec``, the whole vocabulary gathered."""
    if mesh is None:
        return _logits_out(params, hidden, cfg)
    return _logits_mesh(params, hidden, cfg, pcfg, mesh, x_spec, False)


def score_logits(params: dict, hidden: torch.Tensor, cfg: ModelConfig,
                 pcfg: Optional[ParallelConfig] = None, mesh=None,
                 x_spec: Optional[tuple] = None):
    """Vocabulary logits (B, S, V) f32 at EVERY position of final-norm
    ``hidden`` states: the multi-position head of the speculative verify
    step (``head_logits``)."""
    if cfg.num_codebooks > 1:
        raise ValueError("score_logits does not support codebook heads")
    return head_logits(params, hidden, cfg, pcfg, mesh, x_spec)


def forward(params: dict, inputs: dict, cfg: ModelConfig,
            pcfg: ParallelConfig, *, mode: str, cache: Optional[dict] = None,
            paged: Optional[dict] = None,
            active: Optional[torch.Tensor] = None,
            return_hidden: bool = False, mesh=None,
            x_spec: Optional[tuple] = None):
    """Forward pass. Returns (logits, cache, aux_loss, z_loss); with
    ``return_hidden`` the final normed hidden states stand in for the
    logits. With ``pcfg.collect_router_stats`` a fifth element follows:
    the router stats (``obs.device``) summed over every MoE layer, the
    global counts on a mesh (a stack without MoE layers gives
    ``zero_stats(1)``, as JAX's does). ``inputs``: ``tokens`` (B, S) int; siglip configs may add
    ``patches`` (B, P, frontend_dim), put before the tokens; encodec
    configs take ``embeds`` (B, S, frontend_dim) instead of tokens;
    ``cond`` (B, T, cross_d), the cross-attention memory of a
    ``cross_attn`` config.

    ``mode="train"``: the full sequence at positions ``arange(S)``, no
    cache (the returned cache is None).
    ``mode="decode"``: one token per slot at position ``len``, ``active``
    (B,) bool masks slots that write nothing (paged: the sink page; dense:
    the old row written back) and do not advance.
    ``mode="prefill"`` with ``paged``: a chunk continuing at each slot's
    resident length, ``active`` (B, S) marks its valid rows. Without
    ``paged``: the whole prompt at positions ``arange(S)`` into the dense
    cache (``init_cache``; None returns no cache), every slot's length set
    to S. Prefill gives the logits of the last row only.
    ``paged`` (serving): ``{"table": (B, maxp) int32, "page_size": int}``;
    None means the dense cache.

    ``mesh``: a ``launch.mesh.Mesh``; ``params`` are then this rank's
    shards (``param_specs``), the inputs, ``active`` and the dense cache
    its block of the batch (``launch.inputs.batch_block`` under
    ``x_spec[0]``) with the whole sequence, and ``x_spec`` the physical
    spec of the global (B, S, D) activations
    (``launch.inputs.activation_spec``). The hidden states come back at
    ``x_spec``, the logits with the whole sequence and vocabulary; aux
    and z are global. A paged cache on a mesh (``init_paged_cache(
    mesh=)``) holds every page and this rank's K/V heads: the table, the
    lengths and the recurrent state are the batch block's, and each
    written K/V row is gathered over the batch axes before the write, so
    every rank's pools stay alike; the sequence must not be split.
    Without a mesh nothing changes."""
    if mode not in ("train", "decode", "prefill"):
        raise ValueError(f"forward mode {mode!r}: train | prefill | decode")
    if mesh is not None:
        check_mesh(cfg, pcfg, mesh)
        if x_spec is None:
            raise ValueError("a mesh needs x_spec, the activations' "
                             "physical spec")
        if paged is not None and len(x_spec) > 1 \
                and mesh.size(as_axes(x_spec[1])) > 1:
            raise ValueError("the paged cache takes whole sequences: "
                             "x_spec must not split the sequence")
    train = mode == "train"
    dense_prefill = mode == "prefill" and paged is None
    if train and (cache is not None or paged is not None
                  or active is not None):
        raise ValueError("paged cache / active mask are serving-side only")
    if dense_prefill and active is not None:
        raise ValueError("the dense prefill takes whole prompts: no active "
                         "mask")
    dtype = torch_dtype(cfg.dtype)
    ctx = tfm.Ctx(cfg=cfg, pcfg=pcfg, mode=mode, positions=None,
                  cache_len=None, paged=paged, decode_active=active,
                  cond=inputs.get("cond"), mesh=mesh,
                  x_spec=(None, None, None) if mesh is None
                  else tuple(x_spec) + (None,) * (3 - len(x_spec)))
    if mesh is None:
        x = _embed_in(params, inputs, cfg, dtype)
        b, s, _ = x.shape
    else:
        x = _embed_mesh(params, inputs, cfg, ctx, dtype)
        b = x.shape[0]
        s = x.shape[1] * mesh.size(as_axes(ctx.x_spec[1]))
    if train or dense_prefill:
        cache_len = None
        positions = torch.arange(s, device=x.device)[None].expand(b, s)
        cache_layers = ([None] * len(params["layers"]) if cache is None
                        else cache["layers"])
    else:
        cache_len = cache["len"]
        positions = cache_len.long()[:, None] + torch.arange(
            s, device=x.device)
        cache_layers = cache["layers"]
    ctx.positions, ctx.cache_len = positions, cache_len
    x, aux, z, new_layers, stats = run_layers(params["layers"], x, ctx,
                                              cache_layers)
    x = tfm.block_norm(params["final_norm"], x, ctx)

    if return_hidden:
        logits = x
    elif mesh is not None:
        logits = _logits_mesh(params, x, cfg, pcfg, mesh, ctx.x_spec,
                              mode == "prefill")
    elif mode == "prefill":
        logits = _logits_out(params, x[:, -1:], cfg)
    else:
        logits = _logits_out(params, x, cfg)

    n_moe = max(sum(cfg.is_moe_layer(i) for i in range(cfg.num_layers)), 1)
    tail = ()
    if pcfg.collect_router_stats:
        tail = (stats if stats is not None
                else obs_device.zero_stats(1, x.device),)
    if cache is None:
        return (logits, None, aux / n_moe, z / n_moe) + tail
    if dense_prefill:
        new_len = torch.full((b,), s, dtype=torch.int32, device=x.device)
    elif active is None:
        new_len = (cache_len + s).to(torch.int32)
    elif mode == "decode":
        new_len = (cache_len + active.int()).to(torch.int32)
    else:
        new_len = (cache_len + active.int().sum(dim=1)).to(torch.int32)
    new_cache = {"layers": new_layers, "len": new_len}
    return (logits, new_cache, aux / n_moe, z / n_moe) + tail
