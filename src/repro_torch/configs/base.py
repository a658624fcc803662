"""Model / shape configuration dataclasses."""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff: int                     # per-expert hidden size
    period: int = 1               # layer_idx % period == offset -> MoE FFN
    offset: int = 0
    norm_topk: bool = True
    softmax_after_topk: bool = False
    aux_weight: float = 0.01
    z_weight: float = 1e-3


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int = 0              # 0 -> ceil(d_model / 16)
    chunk: int = 128


@dataclasses.dataclass(frozen=True)
class XLSTMConfig:
    proj_factor: float = 2.0
    conv_kernel: int = 4
    chunk: int = 64
    ffn_factor: float = 4.0 / 3.0  # sLSTM block FFN


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                   # dense|moe|hybrid|ssm|audio|vlm|vision-moe
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int                     # dense FFN hidden (0 -> none / MoE only)
    vocab_size: int
    head_dim: int = 0             # 0 -> d_model // num_heads
    act: str = "silu"
    glu: bool = True
    norm: str = "rmsnorm"         # rmsnorm | layernorm
    norm_eps: float = 1e-6
    rope_theta: float = 1e4
    use_rope: bool = True
    qk_norm: bool = False
    logit_softcap: float = 0.0
    embed_scale: bool = False     # gemma-style sqrt(d) embedding scale
    attn_pattern: Tuple[str, ...] = ("global",)   # cycled: global|local
    window: int = 0               # local/SWA window (0 -> none)
    layer_pattern: Tuple[str, ...] = ("attn",)    # cycled: attn|mamba|mlstm|slstm
    moe: Optional[MoEConfig] = None
    mamba: Optional[MambaConfig] = None
    xlstm: Optional[XLSTMConfig] = None
    frontend: Optional[str] = None    # encodec|siglip|None
    frontend_dim: int = 0
    cross_attn: bool = False
    cross_d: int = 0
    num_codebooks: int = 1
    prefix_len: int = 0               # bidirectional prefix (vlm)
    tie_embeddings: bool = True
    dtype: str = "bfloat16"

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def period(self) -> int:
        p = math.lcm(len(self.layer_pattern), len(self.attn_pattern))
        if self.moe is not None:
            p = math.lcm(p, self.moe.period)
        assert self.num_layers % p == 0, (self.name, p, self.num_layers)
        return p

    def layer_kind(self, idx: int) -> str:
        return self.layer_pattern[idx % len(self.layer_pattern)]

    def attn_kind(self, idx: int) -> str:
        return self.attn_pattern[idx % len(self.attn_pattern)]

    def is_moe_layer(self, idx: int) -> bool:
        return (
            self.moe is not None
            and idx % self.moe.period == self.moe.offset
            and self.layer_kind(idx) in ("attn", "mamba")
        )

    def param_count(self) -> int:
        """Approximate total parameter count (for roofline MODEL_FLOPS)."""
        d, l = self.d_model, self.num_layers
        hd = self.hd
        attn = d * hd * (self.num_heads + 2 * self.num_kv_heads) + self.num_heads * hd * d
        total = self.vocab_size * d * (1 if self.tie_embeddings else 2)
        for i in range(l):
            kind = self.layer_kind(i)
            if kind == "attn":
                total += attn
            elif kind == "mamba":
                di = (self.mamba.expand if self.mamba else 2) * d
                ds = self.mamba.d_state if self.mamba else 16
                dtr = (self.mamba.dt_rank or -(-d // 16)) if self.mamba else d // 16
                total += d * 2 * di + di * (dtr + 2 * ds) + dtr * di + di * ds + di * d
            elif kind in ("mlstm", "slstm"):
                pf = self.xlstm.proj_factor if self.xlstm else 2.0
                di = int(pf * d)
                total += 2 * d * di + 3 * di * di // 4 + di * d  # rough
            if self.is_moe_layer(i):
                m = self.moe
                n_mats = 3 if self.glu else 2
                total += m.num_experts * n_mats * d * m.d_ff + d * m.num_experts
            elif self.d_ff:
                n_mats = 3 if self.glu else 2
                total += n_mats * d * self.d_ff
        return total

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: only top-k experts)."""
        if self.moe is None:
            return self.param_count()
        m = self.moe
        n_mats = 3 if self.glu else 2
        n_moe_layers = sum(self.is_moe_layer(i) for i in range(self.num_layers))
        inactive = (
            n_moe_layers * (m.num_experts - m.top_k) * n_mats * self.d_model * m.d_ff
        )
        return self.param_count() - inactive


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}

# long_500k applicability (DESIGN.md §4): sub-quadratic archs only.
LONG_CONTEXT_ARCHS = {
    "jamba_1_5_large_398b",  # hybrid SSM
    "xlstm_350m",            # SSM
    "mixtral_8x7b",          # SWA: KV bounded by window
    "gemma3_12b",            # 5:1 local:global
}
