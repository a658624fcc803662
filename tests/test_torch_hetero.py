"""PyTorch port vs the JAX package: heterogeneous plans (paper §4.4, Eq.
1/2), the data-/model-centric roofline (§4.5, Fig. 10), the
pipeline-shared cache and the per-device-program executor.

* ``core.hetero`` against ``repro.core.hetero`` on a grid of latencies,
  totals and quanta: every split, plan, capacity, padding, key, replan,
  clamp, mask and packed batch equal (integers exactly, the largest-
  remainder rounding included);
* ``parallel.autotune`` against ``repro.parallel.autotune`` with the same
  ``HardwareProfile`` and ``Topology`` passed to both: the same mode
  choices and crossovers, latencies and byte counts within 1e-12
  relative; ``resolve_layer_mode``/``plan_layer_modes`` with the port's
  default profile swapped for the one JAX reads;
* ``PipelineSharedCache``/``PlanCache`` behaviour, as
  ``tests/test_autotune.py`` pins the JAX cache's, and
  ``gathered_layer_bytes``;
* ``HeteroExecutor`` against the JAX ``HeteroExecutor`` (its ``blocked``
  impl, as the JAX CPU tests run it), both modes, GLU and MLP, uniform and
  skewed plans and an 8-bit device class: outputs within 1e-5 (f32), the
  per-device bytes equal; and ``init_moe_ffn(plan=)``'s padded columns.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hetero as jh
from repro.parallel import autotune as ja
from repro.parallel import cache as jc
from repro.parallel.hetero_exec import HeteroExecutor as JExec
from repro.parallel.sharding import ParallelConfig as JPC
from repro_torch.core import hetero as th
from repro_torch.parallel import autotune as ta
from repro_torch.parallel import cache as tc
from repro_torch.parallel.hetero_exec import HeteroExecutor as TExec
from repro_torch.parallel.sharding import ParallelConfig as TPC

torch.set_num_threads(1)

LATS = [(1.0, 2.0), (4.58, 3.06), (3.20, 3.18), (3.28, 9.42),
        (1.0, 1.7, 9.4), (3.3, 0.2, 1.0, 1.0, 8.0), (1.0, 1.0, 1.0, 2.0)]
REL = 1e-12
EXEC_TOL = 1e-5


# ---------------------------------------------------------------------------
# core.hetero
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lat", LATS, ids=str)
def test_splits_and_plans_equal_jax(lat):
    for total, q in ((96, 1), (120, 1), (1536, 128), (1024, 128), (64, 8)):
        if total % q or total // q < len(lat):
            continue
        assert th.proportional_split(lat, total, quantum=q) == \
            jh.proportional_split(lat, total, quantum=q)
        assert th.fit_quantum(total, q, len(lat)) == \
            jh.fit_quantum(total, q, len(lat))
    tp = [th.DeviceProfile(f"d{i}", t) for i, t in enumerate(lat)]
    jp = [jh.DeviceProfile(f"d{i}", t) for i, t in enumerate(lat)]
    assert th.plan_data_centric(tp, 120) == jh.plan_data_centric(jp, 120)
    assert th.plan_model_centric(tp, 1536) == jh.plan_model_centric(jp, 1536)
    shares = th.plan_data_centric(tp, 120)
    assert th.step_latency_model(tp, shares, 120, fixed_overhead_s=0.1) == \
        jh.step_latency_model(jp, shares, 120, fixed_overhead_s=0.1)
    times = [t * s for t, s in zip(lat, shares)]
    for q, sm in ((1, 0.5), (4, 0.25)):
        assert th.replan_from_step_times(times, shares, 120, quantum=q,
                                         smoothing=sm) == \
            jh.replan_from_step_times(times, shares, 120, quantum=q,
                                      smoothing=sm)
    for kw in (dict(global_batch=96, hidden_size=1024),
               dict(global_batch=120, hidden_size=1536, token_quantum=8,
                    capacity_headroom=1.5),
               dict(global_batch=64, hidden_size=64, hidden_quantum=16,
                    expert_bits=(8,) + (16,) * (len(lat) - 1)),
               dict(hidden_size=768, tp_latencies=(1.0, 2.0, 2.0, 4.0))):
        a, b = th.make_hetero_plan(lat, **kw), jh.make_hetero_plan(lat, **kw)
        assert dataclasses.astuple(a) == dataclasses.astuple(b)
        assert a.key() == b.key()
        if a.token_counts is not None:
            assert a.batch_capacity == b.batch_capacity
            counts = th.replan_from_step_times(
                times, a.token_counts, sum(a.token_counts),
                quantum=a.token_quantum)
            assert dataclasses.astuple(a.with_token_counts(counts)) == \
                dataclasses.astuple(b.with_token_counts(counts))
        if a.hidden_splits is not None:
            assert (a.hidden_capacity, a.padded_hidden_size(),
                    a.hidden_padded()) == (b.hidden_capacity,
                                           b.padded_hidden_size(),
                                           b.hidden_padded())
            np.testing.assert_array_equal(th.hidden_mask(a),
                                          jh.hidden_mask(b))
        try:
            ub = jh.uniform_counterpart(b)
        except ValueError:
            with pytest.raises(ValueError):
                th.uniform_counterpart(a)
        else:
            assert dataclasses.astuple(th.uniform_counterpart(a)) == \
                dataclasses.astuple(ub)


def test_clamp_pack_uniform_and_validation_equal_jax():
    for shares, cap, q in (([10, 2, 0, 4], 6, 2), ([7, 1], 4, 1),
                           ([3, 3, 3], 3, 1)):
        assert th.clamp_shares(shares, cap, quantum=q) == \
            jh.clamp_shares(shares, cap, quantum=q)
    for bad in (([10, 10], 6, 1), ([4, 4], 3, 2)):
        for mod in (th, jh):
            with pytest.raises(ValueError):
                mod.clamp_shares(*bad[:2], quantum=bad[2])
    assert dataclasses.astuple(th.uniform_plan(4, global_batch=32)) == \
        dataclasses.astuple(jh.uniform_plan(4, global_batch=32))
    plan_t = th.make_hetero_plan((1.0, 3.0), global_batch=10,
                                 token_quantum=2)
    plan_j = jh.make_hetero_plan((1.0, 3.0), global_batch=10,
                                 token_quantum=2)
    rng = np.random.default_rng(3)
    batch = {"tokens": rng.integers(0, 9, size=(10, 4)),
             "loss_mask": np.ones((10, 4), np.float32)}
    pt, pj = th.pack_batch(batch, plan_t), jh.pack_batch(batch, plan_j)
    for k in batch:
        np.testing.assert_array_equal(pt[k], pj[k])
    for mod in (th, jh):
        with pytest.raises(ValueError):
            mod.HeteroPlan(proxy_latencies=(1.0, 2.0), expert_bits=(4, 16))
        with pytest.raises(ValueError):
            mod.proportional_split([1.0, 0.0], 4)
        with pytest.raises(ValueError):
            mod.fit_quantum(3, 128, 4)


# ---------------------------------------------------------------------------
# autotune
# ---------------------------------------------------------------------------

HW = [dict(peak_flops=197e12, hbm_bw=819e9, link_bw=50e9),
      dict(peak_flops=ta.H100_SXM.peak_flops, hbm_bw=ta.H100_SXM.hbm_bw,
           link_bw=ta.H100_SXM.link_bw)]
TOPO = [None, dict(intra_bw=50e9, inter_bw=12.5e9, node_size=4),
        dict(intra_bw=450e9, inter_bw=50e9, node_size=8)]
SHAPES = [(384, 1536, 8, 1), (768, 3072, 8, 1), (2048, 768, 128, 8),
          (4096, 14336, 8, 2)]


def _hw(mod, hw, topo):
    t = None if topo is None else mod.Topology(**topo)
    return mod.HardwareProfile(**hw, topology=t)


def _rel(a, b):
    assert abs(a - b) <= REL * max(abs(a), abs(b), 1e-300), (a, b)


@pytest.mark.parametrize("hw", range(len(HW)), ids=["a", "h100"])
@pytest.mark.parametrize("topo", range(len(TOPO)), ids=["flat", "t4", "t8"])
def test_roofline_equals_jax(hw, topo):
    th_, jh_ = _hw(ta, HW[hw], TOPO[topo]), _hw(ja, HW[hw], TOPO[topo])
    for d, f, e, k in SHAPES:
        for n_dev in (2, 4, 8, 16, 1.5, 3.25):
            for fused in (True, False):
                for bits in (16, 8):
                    kw = dict(fused_ffn=fused, weight_bits=bits)
                    for mode in ta.CHOOSABLE_MODES:
                        for tokens in (16, 4096, 25088, 131072):
                            _rel(ta.layer_latency(mode, tokens, d, f, e, k,
                                                  n_dev, th_, **kw),
                                 ja.layer_latency(mode, tokens, d, f, e, k,
                                                  n_dev, jh_, **kw))
                    for tokens in (16, 512, 25088):
                        assert ta.choose_mode(tokens, d, f, e, k, n_dev=n_dev,
                                              hw=th_, **kw) == \
                            ja.choose_mode(tokens, d, f, e, k, n_dev=n_dev,
                                           hw=jh_, **kw)
                    assert ta.crossover_tokens(d, f, e, k, n_dev=n_dev,
                                               hw=th_, **kw) == \
                        ja.crossover_tokens(d, f, e, k, n_dev=n_dev, hw=jh_,
                                            **kw)
        for lat, bits in (((1.0, 2.0), 16), ((1.0, 1.0, 1.0, 2.0), (8, 16,
                                                                    16, 8))):
            tok = th.proportional_split(lat, 4096)
            hid = th.proportional_split(lat, f, quantum=128 if f % (
                128 * len(lat)) == 0 else 1)
            for mode in ta.CHOOSABLE_MODES:
                _rel(ta.layer_latency_uneven(mode, 4096, d, f, e, k, lat,
                                             token_shares=tok,
                                             hidden_shares=hid, hw=th_,
                                             weight_bits=bits),
                     ja.layer_latency_uneven(mode, 4096, d, f, e, k, lat,
                                             token_shares=tok,
                                             hidden_shares=hid, hw=jh_,
                                             weight_bits=bits))
        for a, s in ((ta, th_), (ja, jh_)):
            assert a.spec_decode_speedup(0.6, 4, d, f, e, k, hw=s) > 0
        _rel(ta.spec_decode_speedup(0.6, 4, d, f, e, k, hw=th_),
             ja.spec_decode_speedup(0.6, 4, d, f, e, k, hw=jh_))
        _rel(ta.spec_verify_latency(5, d, f, e, k, hw=th_),
             ja.spec_verify_latency(5, d, f, e, k, hw=jh_))
    _rel(ta.serve_decode_attn_latency(
        "paged", num_slots=8, max_seq=4096, hq=32, hkv=4, hd=128,
        lengths=[0, 33, 700, 4096, 9000], hw=th_),
        ja.serve_decode_attn_latency(
            "paged", num_slots=8, max_seq=4096, hq=32, hkv=4, hd=128,
            lengths=[0, 33, 700, 4096, 9000], hw=jh_))


def test_topology_bytes_and_serve_models_equal_jax():
    for spec in ("50e9:12.5e9:4", "450e9:50e9:8"):
        assert dataclasses.astuple(ta.Topology.parse(spec)) == \
            dataclasses.astuple(ja.Topology.parse(spec))
    for n_dev in (1, 4, 8, 16, 32):
        t, j = ta.Topology(node_size=4), ja.Topology(node_size=4)
        t = dataclasses.replace(t, intra_bw=50e9, inter_bw=12.5e9)
        assert (t.n_nodes(n_dev), t.is_flat(n_dev)) == \
            (j.n_nodes(n_dev), j.is_flat(n_dev))
        for mode in ta.CHOOSABLE_MODES:
            for hier in (True, False):
                assert ta.moe_coll_bytes(mode, 4096, 2048, 768, 128, 8,
                                         n_dev=n_dev, topology=t,
                                         hierarchical=hier) == \
                    ja.moe_coll_bytes(mode, 4096, 2048, 768, 128, 8,
                                      n_dev=n_dev, topology=j,
                                      hierarchical=hier)
        for k in (1, 2, 8):
            for hier in (True, False):
                _rel(ta.dispatch_inter_bytes(4096, 2048, k, n_dev=n_dev,
                                             node_size=4, hierarchical=hier),
                     ja.dispatch_inter_bytes(4096, 2048, k, n_dev=n_dev,
                                             node_size=4, hierarchical=hier))
    for kind in ("dense", "paged"):
        for lens in (None, [0, 1, 17, 64], [300, 5]):
            kw = dict(num_slots=4 if lens is None or len(lens) == 4 else 2,
                      max_seq=64, hq=8, hkv=2, hd=16, lengths=lens, page=16)
            assert ta.decode_attn_bytes(kind, **kw) == \
                ja.decode_attn_bytes(kind, **kw)
    for a in (0.0, 0.3, 0.99, 1.0):
        for k in (0, 1, 4, 8):
            _rel(ta.expected_verify_tokens(a, k),
                 ja.expected_verify_tokens(a, k))
    for lat in LATS:
        _rel(ta.effective_devices(lat), ja.effective_devices(lat))
    with pytest.raises(ValueError):
        ta.Topology(intra_bw=0.0)
    with pytest.raises(ValueError):
        ta.Topology.parse("1:2")


class _FakeMesh:
    def __init__(self, **shape):
        self.axis_names = tuple(shape)
        self.shape = shape


def test_resolve_and_plan_layer_modes_equal_jax(monkeypatch):
    """JAX's chooser reads its default profile; the port's reads
    ``H100_SXM``, swapped here for the same numbers."""
    from repro.configs import get_smoke_config as jcfg
    from repro_torch.configs import get_smoke_config as tcfg

    monkeypatch.setattr(ta, "H100_SXM", ta.HardwareProfile(
        peak_flops=ja.V5E.peak_flops, hbm_bw=ja.V5E.hbm_bw,
        link_bw=ja.V5E.link_bw))
    plan_kw = dict(hidden_size=4096, hidden_quantum=128)
    lat4 = [1.0, 1.0, 1.0, 4.0]
    cfgs = [dict(mode="auto"), dict(mode="auto", forced_layer_mode="data_"
                                    "centric"),
            dict(mode="auto", layer_mode_plan=("model_centric", None)),
            dict(mode="auto", device_latencies=(1.0, 2.0)),
            dict(mode="auto", device_latencies=tuple(lat4)),
            dict(mode="auto", quant="int8"),
            dict(mode="auto", topology="t")]
    for mesh in (_FakeMesh(data=2, model=4), _FakeMesh(data=8),
                 _FakeMesh(pod=2, data=2, model=2)):
        for kw in cfgs + [dict(mode="auto", hetero_plan="p")]:
            tkw, jkw = dict(kw), dict(kw)
            if kw.get("hetero_plan"):
                tkw["hetero_plan"] = th.make_hetero_plan(lat4, **plan_kw)
                jkw["hetero_plan"] = jh.make_hetero_plan(lat4, **plan_kw)
            if kw.get("topology"):
                tkw["topology"] = ta.Topology(intra_bw=50e9, inter_bw=12.5e9,
                                              node_size=4)
                jkw["topology"] = ja.Topology(intra_bw=50e9, inter_bw=12.5e9,
                                              node_size=4)
            tcf, jcf = TPC(**tkw), JPC(**jkw)
            for tokens in (8, 256, 8192, 32768):
                for li in (None, 0, 1):
                    assert ta.resolve_layer_mode(
                        tokens, d=1024, f=4096, e=8, k=2, cfg=tcf, mesh=mesh,
                        layer_idx=li) == ja.resolve_layer_mode(
                        tokens, d=1024, f=4096, e=8, k=2, cfg=jcf, mesh=mesh,
                        layer_idx=li)
            for arch in ("qwen3-moe-30b-a3b", "jamba-1.5-large-398b"):
                for tokens in (16, 65536):
                    assert ta.plan_layer_modes(tcfg(arch), tcf, mesh,
                                               tokens) == \
                        ja.plan_layer_modes(jcfg(arch), jcf, mesh, tokens)


def test_default_profile_is_the_h100s():
    hw = ta.H100_SXM
    assert hw.link_bw == 450e9                 # NVIDIA's NVLink 4, each way
    assert 5e14 < hw.peak_flops < 1.2e15       # bf16 dense on an H100 SXM
    assert 2e12 < hw.hbm_bw < 3.5e12
    assert not hasattr(ta, "V5E")


# ---------------------------------------------------------------------------
# the pipeline-shared cache (tests/test_autotune.py's, on the port's)
# ---------------------------------------------------------------------------

def test_cache_never_exceeds_capacity():
    gathers = []
    layer = {"w": torch.zeros((4, 8, 16), dtype=torch.bfloat16)}

    def gather(li):
        gathers.append(li)
        return layer

    cache = tc.PipelineSharedCache(2)
    for li in range(10):
        cache.fetch(li, lambda li=li: gather(li))
        assert cache.resident_layers <= 2
        if li + 1 < 10:
            cache.prefetch(li + 1, lambda li=li: gather(li + 1))
            assert cache.resident_layers <= 2
    st = cache.stats()
    assert st["peak_resident_layers"] == 2
    assert (st["misses"], st["prefetches"], st["hits"],
            st["evictions"]) == (1, 9, 9, 8)
    assert gathers == list(range(10))
    assert st["peak_resident_bytes"] == 2 * tc.tree_bytes(layer) == \
        2 * 4 * 8 * 16 * 2


def test_cache_capacity_one_regather_and_validation():
    calls = {"n": 0}

    def gather():
        calls["n"] += 1
        return {"w": torch.zeros((2, 2))}

    cache = tc.PipelineSharedCache(1)
    for li in range(5):
        cache.fetch(li, gather)
        assert cache.resident_layers == 1
    assert cache.stats()["peak_resident_layers"] == 1
    calls["n"] = 0
    cache.fetch("a", gather)
    cache.fetch("b", gather)     # evicts a
    cache.fetch("a", gather)     # gathers again
    cache.fetch("a", gather)     # resident: a hit
    assert calls["n"] == 3
    with pytest.raises(ValueError):
        tc.PipelineSharedCache(0)


def test_plan_cache_bounds_per_plan_programs():
    built = []
    cache = tc.PlanCache(4)
    plans = [th.make_hetero_plan((1.0, 1.0, 1.0, 1.0), global_batch=32,
                                 capacity_headroom=1.5)]
    plans.append(plans[0].with_token_counts(
        th.replan_from_step_times([1.0, 1.0, 1.0, 2.4], plans[0].token_counts,
                                  32)))
    assert plans[1].token_counts != plans[0].token_counts
    assert max(plans[1].token_counts) <= plans[0].batch_capacity
    for p in (plans[0], plans[1], plans[1], plans[0], plans[1]):
        cache.fetch(p.key(), lambda p=p: built.append(p.key()) or
                    (lambda: p.token_counts))
    assert len(built) == 2 and cache.stats()["hits"] == 3
    assert cache.resident_bytes() == 0


def test_gather_ffn_params_no_mesh_and_layer_bytes():
    ffn = {k: torch.zeros(s) for k, s in (("router", (8, 4)),
                                           ("w_gate", (4, 8, 16)),
                                           ("w_up", (4, 8, 16)),
                                           ("w_down", (4, 16, 8)))}
    out = tc.gather_ffn_params(ffn, TPC(mode="auto"), None)
    assert set(out) == set(ffn) and all(out[k] is ffn[k] for k in ffn)
    for glu in (True, False):
        for d, f, e in ((384, 1536, 8), (2048, 768, 128)):
            for b in (2, 4):
                assert tc.gathered_layer_bytes(d, f, e, glu=glu,
                                               bytes_per_el=b) == \
                    jc.gathered_layer_bytes(d, f, e, glu=glu,
                                            bytes_per_el=b)


# ---------------------------------------------------------------------------
# per-device-program execution (tests/test_hetero_exec.py's, on the port's)
# ---------------------------------------------------------------------------

def _layer(glu, d=16, f=64, e=4, seed=4):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    p = {"router": (rng.normal(size=(d, e)) * 0.1).astype(f32)}
    if glu:
        for name, shape in (("w_gate", (e, d, f)), ("w_up", (e, d, f)),
                            ("w_down", (e, f, d))):
            p[name] = (rng.normal(size=shape) * 0.1).astype(f32)
    else:
        p.update(w1=(rng.normal(size=(e, d, f)) * 0.1).astype(f32),
                 b1=np.full((e, f), 0.1, f32),
                 w2=(rng.normal(size=(e, f, d)) * 0.1).astype(f32),
                 b2=np.full((e, d), 0.05, f32))
    return p


EXEC_CASES = [(m, glu, lat, bits)
              for m in ("data_centric", "model_centric")
              for glu in (True, False)
              for lat, bits in (((1.0, 3.0), None), ((1.0, 1.0), None),
                                ((1.0, 2.0), (16, 8)))]


@pytest.mark.parametrize(
    "mode,glu,lat,bits", EXEC_CASES,
    ids=[f"{m}-{'glu' if g else 'mlp'}-{'-'.join(map(str, lat))}"
         f"{'-int8' if b else ''}" for m, g, lat, b in EXEC_CASES])
def test_hetero_executor_matches_jax(mode, glu, lat, bits):
    d, f, e, k, n = 16, 256, 4, 2, 40
    p = _layer(glu, d=d, f=f, e=e)
    x = np.random.default_rng(5).normal(size=(n, d)).astype(np.float32)
    kw = dict(global_batch=n, hidden_size=f, token_quantum=8,
              hidden_quantum=64, expert_bits=bits)
    pt, pj = th.make_hetero_plan(lat, **kw), jh.make_hetero_plan(lat, **kw)
    common = dict(num_experts=e, top_k=k, act="silu", glu=glu, mode=mode,
                  blk=8)
    ex_t = TExec({a: torch.from_numpy(v) for a, v in p.items()}, plan=pt,
                 **common)
    ex_j = JExec({a: jnp.asarray(v) for a, v in p.items()}, plan=pj,
                 impl="blocked", **common)
    yt = ex_t(torch.from_numpy(x)).numpy()
    yj = np.asarray(ex_j(jnp.asarray(x)))
    np.testing.assert_allclose(yt, yj, rtol=0, atol=EXEC_TOL)
    assert ex_t.device_param_bytes() == ex_j.device_param_bytes()
    assert ex_t.skews == ex_j.skews
    st = ex_t.timed_step(torch.from_numpy(x), rounds=1)
    assert st.step_latency_s > 0 and len(st.device_times_s) == 2
    np.testing.assert_array_equal(st.y.numpy(), yt)


def test_hetero_executor_slices_are_owned_and_refusals():
    p = {a: torch.from_numpy(v) for a, v in _layer(True, f=256).items()}
    plan = th.make_hetero_plan((1.0, 3.0), hidden_size=256,
                               hidden_quantum=64)
    ex = TExec(p, num_experts=4, top_k=2, act="silu", glu=True, plan=plan,
               mode="model_centric", blk=8)
    for i in range(2):
        for name in ("w_gate", "w_up", "w_down"):
            w = ex.device_params(i)[name]
            assert w.is_contiguous() and w.data_ptr() % 16 == 0
            assert w.untyped_storage().data_ptr() != \
                p[name].untyped_storage().data_ptr()
    bad = th.make_hetero_plan((1.0, 2.0), global_batch=8, hidden_size=512,
                              tp_latencies=(1.0, 1.0, 1.0, 2.0),
                              expert_bits=(8, 16))
    with pytest.raises(ValueError, match="expert_bits"):
        TExec(p, num_experts=4, top_k=2, act="silu", glu=True, plan=bad,
              mode="model_centric", blk=8)
    with pytest.raises(ValueError):
        TExec(p, num_experts=4, top_k=2, act="silu", glu=True, plan=plan,
              mode="data_centric", blk=8)


def test_init_moe_ffn_plan_pads_with_zero_columns():
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import transformer as tfm

    cfg = get_smoke_config("qwen3-moe-30b-a3b")
    f = cfg.moe.d_ff

    def init(plan):
        return tfm.init_moe_ffn(cfg, torch.float32,
                                torch.Generator().manual_seed(3), "cpu",
                                plan=plan)

    base = init(None)
    even = init(th.make_hetero_plan((1.0, 1.0), hidden_size=f,
                                    hidden_quantum=16))
    assert all(torch.equal(base[k], even[k]) for k in base)
    plan = th.make_hetero_plan((1.0, 3.0), hidden_size=f, hidden_quantum=16)
    assert plan.hidden_padded()
    padded = init(plan)
    fp = plan.padded_hidden_size()
    m = torch.from_numpy(th.hidden_mask(plan)).bool()
    assert padded["w_gate"].shape[-1] == fp and padded["w_down"].shape[1] == fp
    assert not padded["w_gate"][..., ~m].any()
    assert not padded["w_up"][..., ~m].any()
    assert not padded["w_down"][:, ~m, :].any()
    assert padded["w_gate"][..., m].abs().sum() > 0
    with pytest.raises(ValueError):
        init(th.make_hetero_plan((1.0, 3.0), hidden_size=2 * f,
                                 hidden_quantum=16))


def test_parallel_config_defaults_are_jax():
    """Every ``ParallelConfig`` field the port has carries JAX's default
    (``cache_layers`` among them, read by the LM's unrolled layer loop);
    the port lacks exactly ``impl``, ``scan_layers`` (one impl a device,
    an unrolled layer loop) and ``fused_ffn`` (its islands always run the
    fused expert FFN); each is refused, not ignored."""
    jf = {f.name: f.default for f in dataclasses.fields(JPC)}
    tf = {f.name: f.default for f in dataclasses.fields(TPC)}
    assert set(jf) - set(tf) == {"impl", "scan_layers", "fused_ffn"}
    assert set(tf) <= set(jf)
    assert {k: v for k, v in jf.items() if k in tf} == tf
    for kw in (dict(fused_ffn=False), dict(scan_layers=True)):
        with pytest.raises(TypeError):
            TPC(**kw)
