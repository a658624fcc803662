"""PyTorch port vs the JAX package: the serving half of obs.

Both ``PagedServer`` engines serve the same requests from the same weights
(``params_from_jax``, f32 smoke configs) with the process-wide obs
recorders on and ``collect_router_stats`` set. Held to the JAX engine:

* the trace's span and instant names, in order (``serve.run``,
  ``serve.prefill_chunk``, ``serve.first_token``, ``serve.decode``,
  ``serve.token``, ``serve.handoff``; ``serve.spec_verify`` with a
  ``SpecDecoder``), the event log's kinds and reasons in order, and the
  TTFT the trace gives (the port's equal to its ``ttft_s``, bit for bit);
* the drained router series: per-expert, drop and routed-token counters
  equal, the entropy gauge within ``ENT_RTOL``;
* the greedy streams, equal to JAX's and to the port's own with obs off;
* the token-wise paged prefill of a recurrent stack (jamba's smoke
  config): its summed stats equal JAX's where every chunk is full, and
  count the valid tokens only where a last chunk is short (JAX's scan
  also routes the padding). A decode step routes every slot, active or
  not, in both packages.

Then the serve CLI's ``--metrics``, ``--metrics-interval``,
``--trace-out`` and ``--events-out`` and the train CLI's ``--metrics``
against the JAX CLIs on the same arguments: the same families, spans,
event kinds and printed obs lines (the CLIs draw their weights each their
own way, so the counts are held to ``top_k`` x routed tokens, not to each
other).
"""
import dataclasses
import json
import re

import jax
import numpy as np
import pytest
import torch

from repro import configs as jcfglib
from repro import obs as jobs
from repro.launch import serve as jserve
from repro.launch import spec as jspec
from repro.launch import train as jtrain
from repro.models import lm as jlm
from repro.parallel.sharding import ParallelConfig as JPC, split_tree
from repro_torch import configs as tcfglib
from repro_torch import obs as tobs
from repro_torch.convert import params_from_jax
from repro_torch.launch import serve as tserve
from repro_torch.launch import spec as tspec
from repro_torch.launch import train as ttrain
from repro_torch.parallel.sharding import ParallelConfig as TPC

torch.set_num_threads(1)

QWEN = "qwen3-moe-30b-a3b"
ENT_RTOL = 1e-5
KW = dict(num_slots=3, page_size=4, num_pages=25, max_pages_per_slot=8,
          prefill_chunk=5)
COUNTERS = ("repro_router_expert_tokens_total",
            "repro_router_dropped_tokens_total",
            "repro_router_routed_tokens_total")


def _configs(arch, **kw):
    return (dataclasses.replace(jcfglib.get_smoke_config(arch),
                                dtype="float32", **kw),
            dataclasses.replace(tcfglib.get_smoke_config(arch),
                                dtype="float32", **kw))


def _params(cj, ct, seed=0):
    pj, _ = split_tree(jlm.init_params(jax.random.PRNGKey(seed), cj))
    return pj, params_from_jax(jax.tree.map(np.asarray, pj), ct,
                               device="cpu")


def _requests(vocab, lengths, max_new=4, seed=11):
    rng = np.random.default_rng(seed)
    return [(i, rng.integers(0, vocab, size=n).astype(np.int32), max_new)
            for i, n in enumerate(lengths)]


def _run(lib, server, reqs):
    for rid, prompt, max_new in reqs:
        server.submit(lib.Request(rid=rid, prompt=prompt, max_new=max_new))
    return {r.rid: list(r.out) for r in server.run()}


def _series(reg, name):
    fam = reg.families.get(name)
    return {} if fam is None else {k: c.value
                                   for k, c in fam.children.items()}


def _serve_both(cj, ct, pj, pt, reqs, *, spec=False, disagg=False,
                collect=True, kw=KW):
    """Both engines with the recorders on: (jax, port) dicts of streams,
    trace events, event-log records, TTFTs and the registries."""
    out = []
    for lib, obs, make in (
            (jserve, jobs, lambda pc: jserve.PagedServer(
                cj, JPC(blk=8, collect_router_stats=pc), None, params=pj,
                disagg=disagg, **kw)),
            (tserve, tobs, lambda pc: tserve.PagedServer(
                ct, TPC(blk=8, collect_router_stats=pc),
                params=pt, device="cpu", disagg=disagg, **kw))):
        obs.configure(reset=True)
        srv = make(collect)
        if spec:
            (jspec if lib is jserve else tspec).SpecDecoder(
                srv, (jspec if lib is jserve else tspec).NGramDrafter(), k=3)
        done = _run(lib, srv, reqs)
        events = list(obs.tracer.events)
        out.append({"done": done, "events": events,
                    "records": list(obs.events.records),
                    "ttft_trace": obs.derive_request_latencies(events)[0],
                    "ttft": dict(srv.ttft_s), "registry": obs.registry,
                    "families": {n: _series(obs.registry, n)
                                 for n in COUNTERS},
                    "entropy": _series(obs.registry,
                                       "repro_router_gate_entropy"),
                    "server": srv})
        obs.configure(metrics=False, tracing=False, event_log=False)
    return out


def _names(events):
    return [(e["name"], e["ph"]) for e in events]


def _kinds(records):
    return [(r["kind"], r["reason"], r.get("detail")) for r in records]


@pytest.mark.parametrize("variant", ["plain", "disagg", "spec"])
def test_paged_server_obs_matches_jax(variant):
    cj, ct = _configs(QWEN)
    pj, pt = _params(cj, ct)
    reqs = _requests(cj.vocab_size, (3, 9, 6, 12, 4))
    j, t = _serve_both(cj, ct, pj, pt, reqs, spec=variant == "spec",
                       disagg=variant == "disagg")
    assert t["done"] == j["done"]
    names = _names(t["events"])
    assert names == _names(j["events"])
    want = {"serve.run", "serve.prefill_chunk", "serve.first_token",
            "serve.token"}
    want |= ({"serve.spec_verify"} if variant == "spec"
             else {"serve.decode"})
    if variant == "disagg":
        want.add("serve.handoff")
    assert want <= {n for n, _ in names}
    assert _kinds(t["records"]) == _kinds(j["records"])
    assert t["ttft_trace"] == t["ttft"]               # bit for bit
    assert set(t["ttft_trace"]) == set(j["ttft_trace"]) == set(t["done"])
    for name in COUNTERS:
        assert t["families"][name] == j["families"][name], name
    routed = t["families"]["repro_router_routed_tokens_total"]
    per_expert = t["families"]["repro_router_expert_tokens_total"]
    assert sum(per_expert.values()) == ct.moe.top_k * sum(routed.values())
    np.testing.assert_allclose(t["entropy"][("serve",)],
                               j["entropy"][("serve",)], rtol=ENT_RTOL)
    # the spans' registrations: the engine's, its pool's and its decoder's
    tr, jr = t["registry"], j["registry"]
    tr.collect()
    jr.collect()
    assert set(tr.families) == set(jr.families)


def test_streams_unchanged_with_obs_on():
    cj, ct = _configs(QWEN)
    _, pt = _params(cj, ct)
    reqs = _requests(cj.vocab_size, (5, 11, 3, 8))
    outs = []
    for on in (False, True):
        tobs.configure(metrics=on, tracing=on, event_log=on, reset=True)
        srv = tserve.PagedServer(ct, TPC(blk=8, collect_router_stats=on),
                                 params=pt, device="cpu", **KW)
        outs.append(_run(tserve, srv, reqs))
    tobs.configure(metrics=False, tracing=False, event_log=False, reset=True)
    assert outs[0] == outs[1]


def test_scan_prefill_stats():
    """jamba's smoke stack prefills token by token. With chunks of 4 and
    prompts of 4 and 8 every chunk is full and the drained counters equal
    JAX's; with a 6-token prompt the port counts its valid tokens only
    (JAX's scan also routes the 2 padding tokens of its last chunk)."""
    cj, ct = _configs("jamba-1.5-large-398b")
    pj, pt = _params(cj, ct)
    kw = dict(KW, prefill_chunk=4)
    n_moe = sum(ct.is_moe_layer(i) for i in range(ct.num_layers))
    j, t = _serve_both(cj, ct, pj, pt, _requests(cj.vocab_size, (4, 8),
                                                 max_new=3), kw=kw)
    assert t["done"] == j["done"]
    for name in COUNTERS:
        assert t["families"][name] == j["families"][name], name
    short = _requests(cj.vocab_size, (6,), max_new=2, seed=3)
    j, t = _serve_both(cj, ct, pj, pt, short, kw=kw)
    assert t["done"] == j["done"]
    routed_t = t["families"]["repro_router_routed_tokens_total"][("serve",)]
    routed_j = j["families"]["repro_router_routed_tokens_total"][("serve",)]
    # 6 prompt tokens and one decode step, each through every MoE layer;
    # the decode step routes all 3 slots, active or not, in both packages
    assert routed_t == (6 + 3) * n_moe
    assert routed_j == (6 + 2 + 3) * n_moe


def _lines(out):
    return [ln for ln in out.splitlines()
            if re.match(r"\[(serve|obs)\] (metrics|trace|TTFT|events|"
                        r"prometheus|chrome|event log)", ln)]


def _shape(line):
    """A printed obs line with its numbers and paths taken out."""
    return re.sub(r"\d+(\.\d+)?|-> \S+", "#", line)


def _cli_files(tmp_path, tag):
    return {k: str(tmp_path / f"{tag}.{k}")
            for k in ("prom", "trace.json", "events.jsonl")}


def _families(path):
    names = set()
    with open(path) as f:
        for line in f:
            if line.startswith("# TYPE "):
                names.add(line.split()[2])
    return names


def _prom_sum(path, name):
    total = 0.0
    with open(path) as f:
        for line in f:
            if line.startswith(name + "{"):
                total += float(line.rsplit(" ", 1)[1])
    return total


def test_serve_cli_obs_flags_match_jax(tmp_path, capsys):
    argv = ["--arch", QWEN, "--smoke", "--paged", "--slots", "3",
            "--page-size", "4", "--max-seq", "32", "--requests", "4",
            "--max-new", "3"]
    seen = {}
    for tag, main, extra in (("jax", jserve.main, []),
                             ("port", tserve.main, ["--device", "cpu"])):
        files = _cli_files(tmp_path, tag)
        main(argv + extra + ["--metrics", files["prom"],
                             "--metrics-interval", "2",
                             "--trace-out", files["trace.json"],
                             "--events-out", files["events.jsonl"]])
        out = capsys.readouterr().out
        with open(files["trace.json"]) as f:
            trace = json.load(f)["traceEvents"]
        with open(files["events.jsonl"]) as f:
            kinds = {json.loads(ln)["kind"] for ln in f}
        seen[tag] = {"lines": [_shape(ln) for ln in _lines(out)],
                     "families": _families(files["prom"]),
                     "spans": {e["name"] for e in trace},
                     "kinds": kinds, "files": files}
    for obs in (jobs, tobs):
        obs.configure(metrics=False, tracing=False, event_log=False,
                      reset=True)
    j, t = seen["jax"], seen["port"]
    assert t["lines"] == j["lines"] and len(t["lines"]) == 4
    assert {f for f in j["families"] if f.startswith("repro_router")} \
        == {f for f in t["families"] if f.startswith("repro_router")} \
        == {"repro_router_expert_tokens_total",
            "repro_router_dropped_tokens_total",
            "repro_router_routed_tokens_total", "repro_router_gate_entropy",
            "repro_router_load_imbalance"}
    serve_fams = {f for f in j["families"]
                  if f.startswith(("repro_serve", "repro_cache"))}
    assert serve_fams <= t["families"]
    assert t["spans"] == j["spans"]
    assert t["kinds"] == j["kinds"]
    k = tcfglib.get_smoke_config(QWEN).moe.top_k
    for s in (j, t):
        prom = s["files"]["prom"]
        assert _prom_sum(prom, "repro_router_expert_tokens_total") == k * \
            _prom_sum(prom, "repro_router_routed_tokens_total") > 0


def test_serve_cli_collects_stats_only_paged_and_moe(tmp_path, capsys):
    """As the JAX CLI: ``--metrics`` without ``--paged``, or on a dense
    stack, writes the registry with no router series."""
    for argv in (["--arch", QWEN], ["--arch", "gemma-2b", "--paged"]):
        prom = str(tmp_path / "m.prom")
        tserve.main(argv + ["--smoke", "--slots", "2", "--max-seq", "32",
                            "--requests", "2", "--max-new", "2", "--device",
                            "cpu", "--metrics", prom])
        assert "[serve] metrics -> " in capsys.readouterr().out
        assert not {f for f in _families(prom)
                    if f.startswith("repro_router")}
    tobs.configure(metrics=False, tracing=False, event_log=False, reset=True)


def test_train_cli_router_series_match_jax(tmp_path, capsys):
    argv = ["--arch", QWEN, "--smoke", "--steps", "2", "--global-batch",
            "2", "--seq-len", "16", "--save-every", "100"]
    fams = {}
    for tag, main, extra in (("jax", jtrain.main, []),
                             ("port", ttrain.main, ["--device", "cpu"])):
        prom = str(tmp_path / f"{tag}.prom")
        main(argv + extra + ["--ckpt-dir", str(tmp_path / tag),
                             "--metrics", prom, "--metrics-interval", "1"])
        capsys.readouterr()
        fams[tag] = {f for f in _families(prom)
                     if f.startswith("repro_router")}
        k = tcfglib.get_smoke_config(QWEN).moe.top_k
        routed = _prom_sum(prom, "repro_router_routed_tokens_total")
        n_moe = tcfglib.get_smoke_config(QWEN).num_layers
        assert routed == 2 * 2 * 16 * n_moe
        assert _prom_sum(prom, "repro_router_expert_tokens_total") \
            == k * routed
        with open(prom) as f:
            assert 'phase="train"' in f.read()
    for obs in (jobs, tobs):
        obs.configure(metrics=False, tracing=False, event_log=False,
                      reset=True)
    assert fams["port"] == fams["jax"] and len(fams["port"]) == 5
