"""Quantization (counterpart of ``repro.quant``): block-wise int8/fp8
expert weights served through the quantized kernel branches, int8
paged-KV rows, and quantization-aware training (``fake_quant``).
``quant.core`` is the one rounding and clipping convention."""
from repro_torch.quant.core import (  # noqa: F401
    EXPERT_WEIGHT_KEYS,
    QUANT_DTYPES,
    QUANT_FORMATS,
    QUANT_MODES,
    block_tiles,
    check_scales,
    dequant_tile,
    dequantize_blockwise,
    dequantize_rows,
    fake_quant,
    ffn_scales,
    quant_bits,
    quantize_blockwise,
    quantize_ffn,
    quantize_lm_params,
    quantize_rows,
    scale_block_dims,
)
