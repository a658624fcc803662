"""The operation and byte counts against hand counts."""
import pytest

from hexabench import flops


def _tiny_swin():
    return {"img_size": 16, "patch_size": 4, "in_chans": 3, "depths": [2, 2],
            "dims": [8, 16], "heads": [2, 2], "window": 2, "mlp_ratio": 4.0,
            "num_classes": 10, "moe_stages": [1],
            "moe": {"num_experts": 4, "top_k": 1}, "dtype": "float32"}


def test_swin_forward_flops_by_hand():
    cfg = _tiny_swin()
    # stage 0: 4x4 map (16 tokens), C 8, window 2; stage 1: 2x2, C 16,
    # window 2 (one window), block 1 MoE
    embed = 2 * 16 * 48 * 8
    blk0 = 2 * 16 * 8 * 24 + 2 * 16 * 8 * 8 + 4 * 16 * 4 * 8 + 4 * 16 * 8 * 32
    merge = 2 * 4 * 32 * 16
    blk1 = 2 * 4 * 16 * 48 + 2 * 4 * 16 * 16 + 4 * 4 * 4 * 16
    dense1, moe1 = 4 * 4 * 16 * 64, 2 * 4 * 16 * 4 + 4 * 4 * 16 * 64
    head = 2 * 16 * 10
    want = embed + 2 * blk0 + merge + 2 * blk1 + dense1 + moe1 + head
    assert flops.swin_forward_flops(cfg, 3) == 3 * want
    assert flops.swin_train_flops(cfg, 3) == 9 * want


def test_swin_small_is_8_7_gmac_an_image():
    from hexabench import bench
    cfg = bench.load_json("hexabench/configs/swin_moe_small.json")
    assert flops.swin_forward_flops(cfg, 1) / 2e9 == pytest.approx(8.7466,
                                                                   abs=1e-3)
    layers = flops.swin_expert_layers(cfg, 128)
    assert [r for r, *_ in layers] == [25088] * 9 + [6272]


def test_expert_counts_by_hand():
    f, b = flops.expert_mlp_train_work(rows=10, tokens=10, d=4, h=8,
                                       experts=2, nbytes=4)
    assert f == 3 * 2 * 10 * 4 * 8 * 2
    weights = 2 * (2 * 4 * 8 + 8 + 4)
    assert b == 4 * (3 * weights + 2 * (2 * 10 * 4 + 2 * 10 * 4))
    f, b = flops.expert_glu_launch_work(rows=64, tokens=32, touched=8,
                                        d=4096, f=14336, wbytes=1, xbytes=2)
    assert f == 6 * 64 * 4096 * 14336
    assert b == 8 * 3 * 4096 * 14336 + 8 * 3 * 32 * 112 * 4 \
        + 2 * (32 * 4096 + 64 * 4096)
    # mixtral's decode launch over all 8 experts is bound by its 1.41 GB
    assert flops.bound_s(f, b, "bfloat16") == pytest.approx(b / 3.35e12)


def test_lm_token_flops_by_hand():
    cfg = {"d_model": 8, "num_heads": 2, "num_kv_heads": 1, "head_dim": 4,
           "num_layers": 3, "window": 5, "vocab_size": 11,
           "moe": {"num_experts": 4, "top_k": 2, "d_ff": 6}}
    per = (2 * 8 * 4 * 4 + 2 * 8 * 8) + 4 * 2 * 4 * 5 + 2 * 8 * 4 \
        + 2 * 3 * 2 * 8 * 6
    assert flops.lm_token_flops(cfg, 9) == 3 * per     # the window caps 9
    assert flops.lm_head_flops(cfg) == 2 * 8 * 11


def test_serve_window_operations_count_the_window_only():
    from types import SimpleNamespace

    from hexabench.drivers import serve

    cfg = {"d_model": 8, "num_heads": 2, "num_kv_heads": 1, "head_dim": 4,
           "num_layers": 3, "window": 5, "vocab_size": 11,
           "moe": {"num_experts": 4, "top_k": 2, "d_ff": 6}}
    sent = {7: SimpleNamespace(req=SimpleNamespace(prompt=[0] * 3))}
    server = SimpleNamespace(
        trace=[("admit", 7, 0), ("prefill_chunk", 7, 0, 2),
               ("prefill_chunk", 7, 0, 1), ("decode", (0,))],
        trace_t=[0.0, 1.0, 2.0, 3.0])
    head, tok = flops.lm_head_flops(cfg), flops.lm_token_flops
    # the window holds the prompt's last chunk (position 2, then the head)
    # and one decode (position 3, 4 keys, then the head)
    assert serve.window_operations(server, sent, cfg, 1.5, 3.5) == \
        tok(cfg, 3) + head + tok(cfg, 4) + head
