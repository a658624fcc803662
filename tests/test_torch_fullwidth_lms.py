"""PyTorch port vs the JAX package: the five LM configurations that
``chip_smoke.py`` runs on the card at full width (phases 3d, 4d, 5d, 8d:
gemma-2b, gemma3-12b, phi3-medium-14b, starcoder2-15b, mixtral-8x7b).

* Each one's full-width parameter tree, drawn on the meta device, against
  ``jax.eval_shape`` of the JAX init: every leaf's shape and dtype equal
  (the JAX leaves stacked over periods, unstacked as ``params_from_jax``
  unstacks them); mixtral-8x7b's tree with int8 experts
  (``init_params(quant="int8")``) against ``jax.eval_shape`` of
  ``quantize_lm_params``. The byte totals the card runs reckon are pinned
  within 1 %: mixtral-8x7b's 93.4 GB in bf16 (more than one 80 GB card
  holds) and 48.3 GB with int8 experts.
* (The paged engine past the window on gemma3-12b's and mixtral-8x7b's
  smoke configs, against JAX's ``PagedServer``, is a case of
  ``tests/test_torch_serve.py::test_paged_server_matches_jax``.)
* ``chip_smoke.py``'s table of the five: every cut depth a whole number
  of periods, every crossing prompt longer than its window, the reckoned
  weight and train-state bytes equal to the meta trees' within 1 %, and
  every train state under 64 GB.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jcfglib
from repro.models import lm as jlm
from repro.parallel.sharding import split_tree
from repro.quant import core as jq
from repro_torch import configs as tcfglib
from repro_torch.models import lm as tlm

torch.set_num_threads(1)

FIVE = ["gemma-2b", "gemma3-12b", "phi3-medium-14b", "starcoder2-15b",
        "mixtral-8x7b"]
# mixtral-8x7b's tree in GB: bf16 (46.70 B parameters), and with int8
# experts (45.10 GB of payloads, 3.2 GB of bf16 attention, embeddings and
# routers, 11 MB of scales)
MIXTRAL_GB = {"none": 93.4, "int8": 48.3}
BYTES_RTOL = 0.01
TRAIN_STATE_LIMIT_GB = 64.0
# the state a train step holds between steps: the bf16 weight, its f32
# master, m and v (the bf16 grad lives only inside the step)
BYTES_A_TRAINED_PARAM = 14


def _flat(tree, prefix=""):
    """(dotted name, leaf) of a tree of dicts and lists; None leaves
    skipped."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], f"{prefix}{k}.")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, f"{prefix}{i}.")
    elif tree is not None:
        yield prefix[:-1], tree


def _jax_leaves(jtree, cfg):
    """{port leaf name: (shape, dtype name)} of a JAX abstract tree, each
    period-stacked layer leaf unstacked into its layers."""
    out = {name: (tuple(leaf.shape), jnp.dtype(leaf.dtype).name)
           for name, leaf in _flat({k: v for k, v in jtree.items()
                                    if k != "layers"})}
    n_periods = cfg.num_layers // cfg.period
    for pos, layer in enumerate(jtree["layers"]):
        for name, leaf in _flat(layer):
            assert leaf.shape[0] == n_periods, (pos, name, leaf.shape)
            for pp in range(n_periods):
                out[f"layers.{pp * cfg.period + pos}.{name}"] = (
                    tuple(leaf.shape[1:]), jnp.dtype(leaf.dtype).name)
    return out


def _port_leaves(tree):
    return {name: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for name, t in _flat(tree)}


def _bytes(leaves: dict) -> int:
    return sum(int(np.prod(shape)) * np.dtype(
        jnp.dtype(dtype)).itemsize for shape, dtype in leaves.values())


def _jax_abstract(cfg_j, quant):
    def init(key):
        values, _ = split_tree(jlm.init_params(key, cfg_j))
        if quant != "none":
            values = jq.quantize_lm_params(values, cfg_j, mode=quant)
        return values

    return jax.eval_shape(init, jax.random.PRNGKey(0))


@pytest.mark.parametrize("arch,quant", [(a, "none") for a in FIVE]
                         + [("mixtral-8x7b", "int8")])
def test_full_width_tree_equals_jax(arch, quant):
    cfg_j, cfg_t = jcfglib.get_config(arch), tcfglib.get_config(arch)
    want = _jax_leaves(_jax_abstract(cfg_j, quant), cfg_j)
    got = _port_leaves(tlm.init_params(
        cfg_t, generator=torch.Generator(), device="meta",
        quant=None if quant == "none" else quant))
    assert got.keys() == want.keys()
    bad = {k: (got[k], want[k]) for k in got if got[k] != want[k]}
    assert not bad, bad
    if arch == "mixtral-8x7b":
        gb = _bytes(want) / 1e9
        assert abs(gb - MIXTRAL_GB[quant]) <= BYTES_RTOL * MIXTRAL_GB[quant]
        if quant == "int8":
            int8 = sum(int(np.prod(s)) for s, d in want.values()
                       if d == "int8")
            assert all(d == "int8" for k, (s, d) in want.items()
                       if k.split(".")[-1] in ("w_gate", "w_up", "w_down"))
            assert abs(int8 / 1e9 - 45.10) <= BYTES_RTOL * 45.10


# ---------------------------------------------------------------------------
# chip_smoke.py's table of the five
# ---------------------------------------------------------------------------

_CHIP_SMOKE = []


def _chip_smoke():
    if not _CHIP_SMOKE:
        spec = importlib.util.spec_from_file_location(
            "chip_smoke",
            Path(__file__).resolve().parents[1] / "chip_smoke.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        _CHIP_SMOKE.append(mod)
    return _CHIP_SMOKE[0]


def _meta_tree(cfg, quant=None):
    return tlm.init_params(cfg, generator=torch.Generator(), device="meta",
                           quant=quant)


@pytest.mark.parametrize("arch", FIVE)
def test_chip_smoke_fullwidth_table(arch):
    cs = _chip_smoke()
    assert list(cs.FULLWIDTH) == FIVE
    fw = cs.FULLWIDTH[arch]
    cfg = tcfglib.get_config(arch)
    for key, dtype in (("ref_layers", "float32"),
                       ("train_layers", "bfloat16")):
        assert fw[key] % cfg.period == 0, (key, fw[key], cfg.period)
        cut = cs._fullwidth_config(arch, dtype, fw[key])
        assert cut.num_layers == fw[key] and cut.period == cfg.period
        assert (cut.d_model, cut.num_heads, cut.num_kv_heads, cut.hd,
                cut.vocab_size) == (cfg.d_model, cfg.num_heads,
                                    cfg.num_kv_heads, cfg.hd,
                                    cfg.vocab_size)
    if cfg.moe is not None:
        assert cs._fullwidth_config(arch, "float32").moe.d_ff == \
            cs.HYBRID_REF_FFN
        assert cs._fullwidth_config(arch, "bfloat16").moe.d_ff == \
            cfg.moe.d_ff
    if cfg.window:
        assert fw["cross"] > cfg.window
    else:
        assert fw["cross"] == 0
    quant = "int8" if cfg.moe is not None else None
    weight_gb = _bytes(_port_leaves(_meta_tree(cfg, quant))) / 1e9
    assert abs(weight_gb - fw["weight_gb"]) <= BYTES_RTOL * fw["weight_gb"]
    cut = dataclasses.replace(cfg, num_layers=fw["train_layers"])
    n_params = sum(int(np.prod(s)) for s, _ in
                   _port_leaves(_meta_tree(cut)).values())
    state_gb = BYTES_A_TRAINED_PARAM * n_params / 1e9
    assert abs(state_gb - fw["train_gb"]) <= BYTES_RTOL * fw["train_gb"]
    assert fw["train_gb"] < TRAIN_STATE_LIMIT_GB
