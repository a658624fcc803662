"""PyTorch port vs the JAX package: the frontend families on a mesh.

``test_torch_mesh_recurrent.py``'s harness (4 gloo ranks on a ("data",
"model") mesh of (2, 2) against JAX's GSPMD run, hybrid, f32) on the
2-layer smoke configs of

* paligemma-3b: 8 SigLIP patches projected (``proj`` (None, "fsdp")) and
  put before 8 token rows under the prefix-LM mask; MQA, so attention
  takes the sequence-parallel branch; a tied head;
* musicgen-large: EnCodec frames projected, cross-attention to 64 rows
  of T5 conditioning (``wk``/``wv`` (None, "tp")), and 4 codebook heads
  (``cb_heads`` (None, "fsdp", "tp"), vocabulary-parallel each, the loss
  averaged over them).

Each is held to JAX's mesh run: the loss and the logits within 1e-5 x
max|ref|, aux and z within 1e-6 relative, every gathered gradient leaf
within 1e-4 x its max|grad| (musicgen's unused token embedding and head
get zero on both sides).
"""
import pytest

from test_torch_mesh_recurrent import (
    check_grads,
    check_loss_logits,
    run_module,
)

CUTS = {"paligemma-3b": {}, "musicgen-large": {}}


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run_module(tmp_path_factory.mktemp("mesh_fe"), list(CUTS), CUTS)


@pytest.mark.parametrize("arch", list(CUTS))
def test_frontend_mesh_loss_logits_match_jax(results, arch):
    check_loss_logits(results, arch)


@pytest.mark.parametrize("arch", list(CUTS))
def test_frontend_mesh_grads_match_jax(results, arch):
    check_grads(results, arch, CUTS)
