"""The frozen references agree with the port's CPU path at smoke sizes
(a test may import both; a reference imports nothing of the port)."""
import numpy as np
import pytest
import torch

from hexabench import inputs
from hexabench.reference import mixtral as ref_lm
from hexabench.reference import swin as ref_swin
from hexabench.tests import smoke


def test_swin_loss_and_grads_match_the_port():
    from hexabench.models.swin import port_config as swin_config
    from repro_torch.models import swin
    from repro_torch.parallel.sharding import ParallelConfig

    cfg = smoke.swin_cell().config
    p = inputs.swin_params(cfg, 3, "cpu")
    gen = inputs.generator("cpu", 3, "b")
    images, labels = inputs.image_batch(cfg, 4, gen, "cpu")
    leaves = [t for _, t in inputs.leaves(p)]
    for t in leaves:
        t.requires_grad_(True)
    port = swin.make_loss_fn(swin_config(cfg), ParallelConfig(blk=8))
    lp, _ = port(p, images, labels)
    gp = torch.autograd.grad(lp, leaves, allow_unused=True)
    lr = ref_swin.loss(p, images, labels, cfg)
    gr = torch.autograd.grad(lr, leaves, allow_unused=True)
    assert float(lp.detach()) == pytest.approx(float(lr.detach()), rel=1e-6)
    for a, b in zip(gp, gr):
        a = torch.zeros_like(b) if a is None else a
        assert torch.allclose(a, b, rtol=1e-4, atol=1e-6)


def test_lm_logits_match_the_port():
    from hexabench.drivers.serve import lm_config
    from repro_torch.models import lm
    from repro_torch.parallel.sharding import ParallelConfig

    cfg = smoke.lm_cell().config
    cfg["dtype"] = "float32"            # the port in f32: a tight check
    params = inputs.lm_params(cfg, 5, "cpu", quant="int8")
    tokens = np.random.default_rng(0).integers(0, 128, 40)
    out = lm.forward(params, {"tokens": torch.as_tensor(tokens)[None]},
                     lm_config(cfg), ParallelConfig(blk=8), mode="train")
    port_logits = out[0][0] if isinstance(out, tuple) else out[0]
    ref = ref_lm.logits_at(cfg, 5, "cpu", [tokens], [np.arange(40)],
                           quant="int8")[0]
    assert torch.allclose(port_logits.float(), ref, rtol=1e-4, atol=1e-4)


def test_controls_round_below_f32():
    from hexabench.reference.precision import round_fp8, round_tf32

    x = torch.tensor([1.0 + 2 ** -12, 1.0 + 2 ** -9, 3.0])
    assert torch.equal(round_tf32(x), torch.tensor([1.0, 1.0 + 2 ** -9, 3.0]))
    y = torch.randn(1000)
    assert 0 < (round_fp8(y) - y).abs().max() < 0.1 * y.abs().max()
