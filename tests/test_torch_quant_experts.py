"""Expert-by-expert block-wise quantization.

``quant.core.quantize_blockwise`` quantizes a batched weight (the experts
of an FFN) one leading slice at a time, so no f32 copy of the whole
tensor exists. Blocks never cross an expert, so the payloads and scales
must be bit-equal to the whole tensor quantized in one pass (the port's
``_quantize_whole`` and the JAX package's ``quantize_blockwise``), on
shapes with several experts, a dim smaller than the tile (a clamped,
ragged block) and two leading dims. ``lm.init_params(quant=)``, which
quantizes each expert matrix as it is drawn, equals
``quantize_lm_params`` of the tree drawn without it.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.quant import core as jq
from repro_torch import configs as tcfglib
from repro_torch.models import lm as tlm
from repro_torch.quant import core as tq

torch.set_num_threads(1)

SHAPES = [(3, 96, 256), (4, 256, 40), (2, 3, 384, 128), (5, 8, 24)]


def _bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int8).numpy() if t.dtype != torch.float32 \
        else t.numpy().view(np.int32)


@pytest.mark.parametrize("mode", ["int8", "fp8"])
@pytest.mark.parametrize("shape", SHAPES)
def test_per_expert_equals_whole_tensor(shape, mode):
    rng = np.random.default_rng(sum(shape))
    # experts of different magnitudes, so a block crossing one would show
    w = (rng.normal(size=shape) * np.exp(rng.normal(size=shape[:1] + (1,) * (
        len(shape) - 1)))).astype(np.float32)
    q, s = tq.quantize_blockwise(torch.from_numpy(w), mode=mode)
    qw, sw = tq._quantize_whole(torch.from_numpy(w), mode=mode, tile=128,
                                rng=None)
    np.testing.assert_array_equal(_bits(q), _bits(qw))
    np.testing.assert_array_equal(_bits(s), _bits(sw))
    jqv, js = jq.quantize_blockwise(jnp.asarray(w), mode=mode)
    np.testing.assert_array_equal(
        q.float().numpy(), np.asarray(jqv.astype(jnp.float32)))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s.shape == js.shape


def test_init_params_quantizes_as_drawn():
    cfg = tcfglib.get_smoke_config("jamba-1.5-large-398b")
    drawn = tlm.init_params(cfg, generator=torch.Generator().manual_seed(4),
                            device="cpu", quant="int8")
    plain = tlm.init_params(cfg, generator=torch.Generator().manual_seed(4),
                            device="cpu")
    want = tq.quantize_lm_params(plain, cfg, mode="int8")
    for i, (a, b) in enumerate(zip(drawn["layers"], want["layers"])):
        assert sorted(a) == sorted(b)
        for part in a:
            assert sorted(a[part]) == sorted(b[part]), (i, part)
            for name, t in a[part].items():
                assert t.dtype == b[part][name].dtype
                assert torch.equal(t, b[part][name]), (i, part, name)
        if cfg.is_moe_layer(i):
            assert a["ffn"]["w_gate"].dtype == torch.int8
    assert torch.equal(drawn["head"], want["head"])
