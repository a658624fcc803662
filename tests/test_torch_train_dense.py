"""PyTorch port vs the JAX package: training the dense decoders.

2 AdamW steps of the port's ``make_train_step`` against the JAX
``make_train_step`` on the f32 smoke configs of gemma-2b (MQA, GeGLU,
scaled embeddings), phi3-medium-14b, starcoder2-15b (MLP FFN, layernorm)
and gemma3-12b (local and global layers, windows, qk-norm), every layer
a dense FFN, from the same weights, batches and zero optimizer state:
losses within 1e-5 relative and the grad norm within 1e-4, as
``test_torch_train_hybrid.check_steps`` holds them.
"""
import pytest
import torch

from test_torch_train_hybrid import check_steps

torch.set_num_threads(1)

ARCHS = ["gemma-2b", "phi3-medium-14b", "starcoder2-15b", "gemma3-12b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_match_jax(arch):
    check_steps(arch)
