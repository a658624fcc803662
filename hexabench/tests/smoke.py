"""Smoke-sized cells of the benchmark's configurations, run on the CPU
through the same drivers and references as the cells on the card."""
import copy
import time

from hexabench import bench, traffic

SWIN_SMOKE = dict(img_size=32, depths=[1, 1, 2, 1], dims=[16, 32, 64, 128],
                  heads=[2, 2, 4, 4], window=2, num_classes=10)
LM_SMOKE = dict(num_layers=2, d_model=64, num_heads=4, num_kv_heads=2,
                head_dim=16, vocab_size=128, window=16)
#: Wide enough that fp8 rounding moves some greedy choices.
LM_WIDE = dict(num_layers=4, d_model=256, head_dim=64, vocab_size=4096)


def swin_cell(seed=2 ** 31 + 11, seconds=0.3, limits=None):
    cfg = bench.load_json("hexabench/configs/swin_moe_small.json")
    cfg.update(copy.deepcopy(SWIN_SMOKE))
    cfg["moe"]["num_experts"] = 4
    cfg["train"]["blk"] = 8
    mix = traffic.load("train.img224.b128")
    mix.update(batch=4, warmup_steps=1, trace_steps=2)
    lim = limits or bench.load_json("hexabench/limits/swin_s.train.b128.json")
    return bench.Cell(workload={"name": "swin_smoke", "chips": 1},
                      config=cfg, traffic=mix, limits=lim, end_to_end=[],
                      per_layer=[], seed=seed, seconds=seconds, trace=False,
                      t_start=time.perf_counter(), device="cpu")


class StepClock:
    """A clock that moves ``tick`` seconds at each reading: the serve
    driver's window then holds a fixed number of scheduler steps however
    slow the host (a loaded test host may finish no request in a few real
    seconds)."""

    def __init__(self, tick: float = 0.01):
        self.now, self.tick = 0.0, tick

    def perf_counter(self) -> float:
        self.now += self.tick
        return self.now


def step_clock(monkeypatch, tick: float = 0.01) -> None:
    from hexabench.drivers import serve

    monkeypatch.setattr(serve, "time", StepClock(tick))


def lm_cell(seed=2 ** 31 + 13, seconds=1.0, limits=None, wide=False):
    cfg = bench.load_json("hexabench/configs/mixtral_8x7b.json")
    cfg.update(copy.deepcopy(LM_SMOKE))
    cfg["moe"].update(num_experts=4, d_ff=96)
    if wide:
        cfg.update(LM_WIDE)
        cfg["moe"]["d_ff"] = 512
    mix = traffic.load("serve.chat.c32")
    mix.update(clients=3, strata=4,
               prompt_len={"dist": "loguniform", "min": 4, "max": 24},
               output_len={"dist": "loguniform", "min": 2, "max": 6},
               engine={"slots": 4, "page_size": 8, "pages_per_slot": 4,
                       "prefill_chunk": 8},
               warmup_steps=6, drain_s=60,
               check={"served_tokens": 400 if wide else 12,
                      "max_requests": 40 if wide else 4})
    lim = limits or bench.load_json("hexabench/limits/mixtral.serve.c32.json")
    return bench.Cell(workload={"name": "lm_smoke", "chips": 1},
                      config=cfg, traffic=mix, limits=lim, end_to_end=[],
                      per_layer=[], seed=seed, seconds=seconds, trace=False,
                      t_start=time.perf_counter(), device="cpu")
