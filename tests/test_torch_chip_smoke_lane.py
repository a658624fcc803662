"""``chip_smoke.py``'s CPU lane and the CPU sides it runs, on the CPU.

The card's reference phases (4, 4s, Q2, 4j, 4x, 4d, 7, 7q, 7b, 7f, P1) hand
their CPU sides, checks included, to ``_CpuLane``, which runs them on one
worker thread beside the card's phases. Here:

* the lane runs its jobs in order and returns their results; a failed job
  fails ``submit``, ``result`` and ``join``; ``_this_thread_only`` sends the
  other threads' calls to the real function;
* each CPU side, at a smoke config, accepts the "card" results that the
  same helpers compute on the CPU, and raises when one of those results is
  wrong (a token, a total, a grad, a payload or a logit moved).
"""
import dataclasses
import importlib.util
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs as cfglib
from repro_torch.configs import swin_moe_small
from repro_torch.data.pipeline import DataConfig, TokenSource
from repro_torch.models import lm, swin
from repro_torch.parallel.sharding import ParallelConfig
from repro_torch.quant import core as qcore

torch.set_num_threads(1)

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(cs)


def _smoke(arch, dtype="float32", **kw):
    return dataclasses.replace(cfglib.get_smoke_config(arch), dtype=dtype,
                               **kw)


def _params(cfg, seed=0, quant=None):
    return lm.init_params(cfg, generator=torch.Generator().manual_seed(seed),
                          device="cpu", quant=quant)


def _prompts(cfg, n, length=8, seed=4):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, size=length).astype(np.int32)
            for _ in range(n)]


def _batch(cfg, seed=7):
    return TokenSource(DataConfig(seq_len=16, global_batch=2,
                                  vocab_size=cfg.vocab_size,
                                  seed=seed)).batch(0)


def _moved(streams):
    """``streams`` with the last token of the first stream changed."""
    out = {k: list(v) for k, v in streams.items()}
    first = min(out)
    out[first][-1] += 1
    return out


def _first_grad_moved(grads):
    out = list(grads)
    i = next(i for i, g in enumerate(out) if g is not None)
    out[i] = out[i] + out[i].abs().max() + 1.0
    return out


# ---------------------------------------------------------------------------
# each CPU side: (run it with the CPU's own results, run it with one moved)
# ---------------------------------------------------------------------------

def _case_4(wrong):
    cfg, pcfg = _smoke("qwen3-moe-30b-a3b"), ParallelConfig(blk=16)
    p = _params(cfg, 3)
    prompts = _prompts(cfg, 3)
    want = cs._reference_engine(cfg, pcfg, "dense", "cpu", p, prompts)
    cs._reference_cpu(cfg, pcfg, p, prompts, _moved(want) if wrong else want)


def _case_4s(wrong):
    cfg, pcfg = _smoke("qwen3-moe-30b-a3b"), ParallelConfig(blk=16)
    p = _params(cfg, 5)
    mix = cs._spec_mix(_prompts(cfg, 4, seed=7), 6)
    _, off = cs._spec_reference_run(cfg, pcfg, "off", p, "cpu", mix)
    cs._spec_reference_cpu(cfg, pcfg, p, mix, _moved(off) if wrong else off)


def _case_q2(wrong):
    cfg = _smoke("qwen3-moe-30b-a3b")
    p = _params(cfg, 23, quant="int8")
    prompts = _prompts(cfg, 3, seed=24)
    batch = _batch(cfg, 25)
    scfg = swin_moe_small.SMOKE_CONFIG
    gen = torch.Generator().manual_seed(26)
    sp = swin.init_swin(scfg, generator=gen, device="cpu")
    for stage in sp["stages"]:
        for blk in stage["blocks"]:
            if "moe" in blk:
                blk["moe"] = qcore.quantize_ffn(blk["moe"], mode="int8")
    images, _ = swin.synthetic_batch(scfg, 2, generator=gen, device="cpu")
    total, grads, _ = cs._quant_reference_grads(cfg, p, batch, "cpu")
    with torch.no_grad():
        logits = swin.swin_forward(sp, images, scfg, ParallelConfig(
            blk=128))[0].float()
    card = {"tokens": cs._quant_reference_serve(cfg, p, "cpu", prompts),
            "total": total, "grads": grads, "logits": logits}
    if wrong:
        card["grads"] = _first_grad_moved(grads)
    cs._quant_reference_cpu(cfg, scfg, {"lm": p, "swin": sp,
                                        "images": images},
                            prompts, batch, card)


def _case_hybrid(wrong, arch):
    cfg, pcfg = _smoke(arch), ParallelConfig(blk=16)
    p = _params(cfg, 41)
    prompts = _prompts(cfg, cs.HYBRID_REF_REQUESTS, seed=42)
    want, _ = cs._hybrid_engine(cfg, pcfg, "dense", "cpu", p, prompts)
    chunked = cs._hybrid_prefill(cfg, pcfg, p, np.stack(prompts), "cpu")
    if wrong:
        chunked = chunked + chunked.abs().max()
    kinds, n = cs.HYBRID_CPU[arch]
    cs._hybrid_reference_cpu("4j" if arch.startswith("jamba") else "4x",
                             cfg, pcfg, p, prompts, kinds, n, want, chunked)


def _case_4d(wrong, arch):
    cfg, pcfg = _smoke(arch), ParallelConfig(blk=16)
    p = _params(cfg, 41)
    prompts = _prompts(cfg, cs.FULLWIDTH_REF_REQUESTS,
                       cs.FULLWIDTH_REF_PROMPT, seed=42)
    server = cs._fullwidth_ref_engine(cfg, pcfg, "dense", "cpu", p)
    for r in cs._fullwidth_ref_requests(prompts):
        server.submit(r)
    want = {r.rid: list(r.out) for r in server.run()}
    cs._fullwidth_reference_cpu(arch, cfg, pcfg, p, prompts,
                                _moved(want) if wrong else want)


def _case_7(wrong, arch="qwen3-moe-30b-a3b"):
    cfg, pcfg = _smoke(arch), ParallelConfig(blk=16)
    p = _params(cfg, 7)
    batch = (_batch(cfg) if cfg.frontend is None
             else cs._family_batch(cfg, 2, 16 + cfg.prefix_len, 11))
    _, total, grads = cs._loss_grads(cfg, pcfg, p, batch, "cpu")
    names = [n for n, _ in cs._named_leaves(p)]
    if wrong:
        grads = _first_grad_moved(grads)
    out = cs._cpu_loss_check("7", "7", cfg, pcfg, p, batch, names, total,
                             grads, cs.TRAIN_GRAD_TOL)
    assert out["total_cpu"] == total and out["total_rel_diff"] == 0.0


def _case_7q(wrong):
    cfg = _smoke("qwen3-moe-30b-a3b")
    pcfg = ParallelConfig(blk=16, remat="none", quant="int8")
    p = _params(cfg, 7)
    payloads = [[qcore.quantize_blockwise(layer["ffn"][name], mode="int8")
                 for name in qcore.EXPERT_WEIGHT_KEYS if name in layer["ffn"]]
                for layer in p["layers"]]
    if wrong:
        q, s = payloads[0][0]
        q = q.clone()
        q.view(-1)[0] += 1
        payloads[0][0] = (q, s)
    batch = _batch(cfg)
    _, total, grads = cs._loss_grads(cfg, pcfg, p, batch, "cpu")
    cs._qat_reference_cpu(cfg, pcfg, p, payloads, batch, total, grads)


def _case_7b(wrong):
    cfg, pcfg = _smoke("qwen3-moe-30b-a3b", "bfloat16"), ParallelConfig(
        blk=128)
    p = _params(cfg, 7)
    batch = _batch(cfg)
    card = cs._bf16_loss_picks(cfg, pcfg, p, batch, "cpu")
    assert card[3], "no router call was recorded"
    if wrong:
        card = (card[0], card[1] * 1.1, card[2], card[3])
    cs._bf16_reference_cpu(cfg, pcfg, p, batch, card)


def _case_7f(wrong):
    cfg, pcfg = _smoke("paligemma-3b"), ParallelConfig(blk=16)
    p = _params(cfg, 11)
    card, _ = cs._frontend_serve(torch, cfg, pcfg, p, "cpu", 2, 12)
    if wrong:
        card = [card[0] + card[0].abs().max()] + card[1:]
    cs._frontend_cpu(torch, "paligemma-3b", cfg, pcfg, p, card)


def _case_p1_graft(wrong):
    cfg, pcfg = _smoke("qwen3-moe-30b-a3b", glu=False), ParallelConfig(blk=16)
    p = _params(cfg, 7)
    prompts = _prompts(cfg, 2, seed=11)
    _, got = cs._graft_serve(cfg, pcfg, p, "cpu", None, prompts)
    cs._graft_decode_cpu(cfg, pcfg, p, prompts, _moved(got) if wrong else got)


CASES = {
    "4": _case_4, "4s": _case_4s, "Q2": _case_q2,
    "4j": lambda w: _case_hybrid(w, "jamba-1.5-large-398b"),
    "4x": lambda w: _case_hybrid(w, "xlstm-350m"),
    "4d gemma3-12b": lambda w: _case_4d(w, "gemma3-12b"),
    "4d mixtral-8x7b": lambda w: _case_4d(w, "mixtral-8x7b"),
    "7": _case_7, "7f loss": lambda w: _case_7(w, "paligemma-3b"),
    "7q": _case_7q, "7b": _case_7b, "7f steps": _case_7f,
    "P1 graft": _case_p1_graft,
}


@pytest.mark.parametrize("wrong", [False, True], ids=["equal", "moved"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cpu_side_holds_the_card_results(case, wrong):
    if wrong:
        with pytest.raises(AssertionError):
            CASES[case](True)
    else:
        CASES[case](False)


# ---------------------------------------------------------------------------
# the lane
# ---------------------------------------------------------------------------

def test_lane_runs_jobs_in_order_and_keeps_results():
    lane, seen = cs._CpuLane(), []

    def job(i):
        seen.append((i, threading.current_thread().name))
        return i * i

    for i in range(4):
        lane.submit(f"j{i}", 1, job, i)
    assert lane.result("j2") == 4
    lane.join()
    assert [i for i, _ in seen] == [0, 1, 2, 3]
    assert {name for _, name in seen} == {"cpu-lane"}
    assert lane.result("j3") == 9 and lane._held == 0


def test_lane_failure_fails_the_run():
    lane = cs._CpuLane()

    def bad():
        raise AssertionError("tokens differ")

    lane.submit("bad", 1, bad)
    with pytest.raises(AssertionError, match="CPU lane job bad: tokens"):
        lane.join()
    with pytest.raises(AssertionError, match="tokens differ"):
        lane.submit("after", 1, lambda: None)
    with pytest.raises(AssertionError, match="tokens differ"):
        lane.result("after")


def test_lane_holds_at_most_its_bytes():
    lane, gate, order = cs._CpuLane(), threading.Event(), []
    big = int(cs.LANE_GB * 1e9)
    lane.submit("a", big // 2 + 1, lambda: (gate.wait(10), order.append("a")))

    def submit_b():
        lane.submit("b", big // 2 + 1, lambda: order.append("b"))
        order.append("b submitted")

    t = threading.Thread(target=submit_b)
    t.start()
    t.join(0.3)
    assert t.is_alive(), "the second job was queued past LANE_GB"
    gate.set()
    t.join(10)
    lane.join()
    assert order[0] == "a" and set(order) == {"a", "b", "b submitted"}


def test_this_thread_only_passes_the_other_threads_calls():
    calls = []
    fn = cs._this_thread_only(lambda: calls.append("wrapped") or 1,
                              lambda: calls.append("real") or 2)
    out = []
    t = threading.Thread(target=lambda: out.append(fn()))
    t.start()
    t.join()
    assert fn() == 1 and out == [2] and calls == ["real", "wrapped"]
