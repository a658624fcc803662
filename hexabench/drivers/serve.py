"""The serve driver: the port's paged engine (``launch/serve.py``'s
``PagedServer``) under a closed loop of clients.

Set-up: the weights (``inputs``, experts quantized as drawn), the engine,
and the mix's ``warmup_steps`` scheduler steps of the same loop, which
build and warm every shape the window uses (the fixed prefill chunk and
the decode batch of every slot) and bring the loop to a steady state.

Window: the harness submits and calls one scheduler step at a time
(``run(max_steps=1)``) until ``--seconds`` have passed on the host, then
synchronizes. Each client sends its next request as soon as its reply is
done. A request's time to first token runs from its submission to the end
of the step that drew its first token (each such step ends in the copy of
the tokens to the host); ``serve_ttft_mean_ms`` is the mean over every
request sent inside the window. After the window (and, with ``--trace
1``, ``trace_steps`` more scheduler steps under the profiler, the clients
still sending) no client sends, and the engine steps on until every
request sent inside the window has its first token (at most ``drain_s``).

``correct``: the engine's own logits at every token it draws are kept on
the host as they are drawn (a wrapper around ``launch/serve.py``'s
``draw_rows``, the one place both of its ticks turn logits into tokens).
After the window a sample drawn from the seed of the requests finished in
it, the longest among them, is run through the plain reference
(``reference/mixtral.py``) once the program's state is freed, and at each
served position (``compare``):

* ``logit_err``: the median over the sample's served positions of the
  relative gap between the program's logits and the reference's;
* ``token_excess``: the largest amount by which a served token's
  reference logit lies below the reference's best beyond what the
  program's own logit errors on those two tokens explain; 0 wherever the
  served token is the greedy choice of logits within those errors of the
  reference's, so its limit is 0.

(The gap of a served token alone, widest or mean, does not tell bf16 from
fp8: PERF.md.)
"""
from __future__ import annotations

import dataclasses
import gc
import statistics
import sys
import time

import numpy as np
import torch

from hexabench import bench, devtrace, flops, inputs, traffic


def lm_config(cfg: dict):
    """The port's ``ModelConfig`` of a configuration file."""
    from repro_torch.configs.base import ModelConfig, MoEConfig

    return bench.port_config(ModelConfig, cfg, moe=MoEConfig(**cfg["moe"]))


@dataclasses.dataclass
class Sent:
    req: object
    phase: str
    t_submit: float
    t_first: float = None
    t_done: float = None
    seen: int = 0
    failed: bool = False


class ClosedLoop:
    """``clients`` clients, each with one request in flight; counts the
    tokens each step emits."""

    def __init__(self, server, stream, clients: int):
        self.server, self.stream = server, stream
        self.sent: dict = {}
        self.inflight: set = set()
        self.open = True
        self.phase = "warmup"
        self.steps: list = []   # (phase, host s, prefill tokens, decode rows)
        self._failed_seen = 0
        for _ in range(clients):
            self.submit()

    def submit(self):
        from repro_torch.launch.serve import Request

        r = next(self.stream)
        req = Request(rid=r.index, prompt=r.prompt, max_new=r.max_new)
        self.sent[req.rid] = Sent(req, self.phase, time.perf_counter())
        self.inflight.add(req.rid)
        self.server.submit(req)

    def step(self) -> int:
        """One scheduler step; returns the tokens it emitted."""
        events, t_start = len(self.server.trace), time.perf_counter()
        done = self.server.run(max_steps=1)
        now = time.perf_counter()
        prefill = decode = 0
        for ev in self.server.trace[events:]:
            if ev[0] == "prefill_chunk":
                prefill += ev[3]
            elif ev[0] == "decode":
                decode += len(ev[1])
        self.steps.append((self.phase, now - t_start, prefill, decode))
        emitted = 0
        for rid in self.inflight:
            s = self.sent[rid]
            n = len(s.req.out)
            emitted += max(n - s.seen, 0)
            s.seen = n
            if s.t_first is None and n >= 1:
                s.t_first = now
        ended = [r.rid for r in done]
        for r in self.server.failed[self._failed_seen:]:
            self.sent[r.rid].failed = True
            ended.append(r.rid)
        self._failed_seen = len(self.server.failed)
        for rid in ended:
            self.sent[rid].t_done = now
            self.inflight.discard(rid)
            if self.open:
                self.submit()
        return emitted


def window_operations(server, sent: dict, cfg: dict, t0: float,
                      t1: float) -> float:
    """The model operations of the scheduler events stamped in [t0, t1]:
    each prompt token at its position, each decoded token at its own, the
    head once a prompt and once a decoded token."""
    total, pos, slot_rid = 0.0, {}, {}
    for ev, t in zip(server.trace, server.trace_t):
        ops = 0.0
        if ev[0] == "admit":
            slot_rid[ev[2]], pos[ev[1]] = ev[1], 0
        elif ev[0] == "prefill_chunk":
            rid, n = ev[1], ev[3]
            p = pos[rid]
            ops = sum(flops.lm_token_flops(cfg, c)
                      for c in range(p + 1, p + n + 1))
            if p + n == len(sent[rid].req.prompt):
                ops += flops.lm_head_flops(cfg)
            pos[rid] = p + n
        elif ev[0] == "decode":
            for slot in ev[1]:
                rid = slot_rid[slot]
                pos[rid] += 1
                ops += (flops.lm_token_flops(cfg, pos[rid])
                        + flops.lm_head_flops(cfg))
        if t0 <= t <= t1:
            total += ops
    return total


def _wrap(obj, attr: str, name: str, on_call=None):
    """Put ``obj.attr`` under the profiler range ``name``; ``on_call``
    sees each call's arguments. Returns the undo."""
    fn = getattr(obj, attr)

    def wrapped(*a, **kw):
        if on_call is not None:
            on_call(a, kw)
        with torch.profiler.record_function(name):
            return fn(*a, **kw)

    setattr(obj, attr, wrapped)
    return lambda: setattr(obj, attr, fn)


def _expert_launch(a, kw, launches):
    """``kernels.ops.esffn_glu``'s layout of one launch, kept on the
    device: (valid rows mask (Np,), block -> expert, tokens, D, F,
    weight bytes, x bytes)."""
    x, row_gate, block_expert, w_gate = a[0], a[2], a[3], a[5]
    launches.append((row_gate != 0, block_expert.clone(), x.shape[0],
                     x.shape[1], w_gate.shape[-1], w_gate.element_size(),
                     x.element_size()))


def expert_launch_work(launches: list) -> list:
    """(operations, bytes) of each launch: the rows it routed and the
    experts those rows touched."""
    out = []
    for valid, be, tokens, d, f, wb, xb in launches:
        nblk = be.shape[0]
        rows_in_blk = valid.reshape(nblk, -1).any(-1)
        touched = int(torch.unique(be[rows_in_blk]).numel())
        out.append(flops.expert_glu_launch_work(int(valid.sum()), tokens,
                                                touched, d, f, wb, xb))
    return out


def sample_finished(loop: ClosedLoop, t0: float, t1: float, seed: int,
                    check: dict) -> list:
    """Requests finished in the window: the longest, then others drawn
    from the seed, until ``served_tokens`` are in or ``max_requests``."""
    done = [s.req for s in loop.sent.values()
            if s.t_done is not None and t0 <= s.t_done <= t1 and not s.failed]
    if not done:
        return []
    done.sort(key=lambda r: r.rid)
    longest = max(done, key=lambda r: (len(r.prompt) + len(r.out), -r.rid))
    rest = [r for r in done if r is not longest]
    rng = np.random.default_rng(inputs.derive_seed(seed, "sample"))
    picked, served = [longest], len(longest.out)
    for i in rng.permutation(len(rest)):
        if served >= check["served_tokens"] or \
                len(picked) >= check["max_requests"]:
            break
        picked.append(rest[i])
        served += len(rest[i].out)
    return picked


def capture_logits(store: dict):
    """Keep on the host the program's logits row of every token the engine
    draws, under ``(rid, index of the token)``. Returns the undo."""
    from repro_torch.launch import serve as port_serve

    real = port_serve.draw_rows

    def draw_rows(rows, reqs, steps=None, mesh=None):
        drawn = real(rows, reqs, steps, mesh)
        idx = [i for i, r in enumerate(reqs) if r is not None]
        host = rows.detach()
        host = (host if len(idx) == len(reqs) else host[idx]).cpu()
        for j, i in enumerate(idx):
            k = len(reqs[i].out) if steps is None else int(steps[i])
            store[(reqs[i].rid, k)] = host[j]
        return drawn

    port_serve.draw_rows = draw_rows
    return lambda: setattr(port_serve, "draw_rows", real)


def served_positions(reqs: list) -> tuple:
    """Each request's prompt and served tokens but the last, and the
    positions whose logits drew its served tokens."""
    seqs = [np.concatenate([r.prompt, np.asarray(r.out[:-1], np.int32)])
            for r in reqs]
    pos = [np.arange(len(r.prompt) - 1, len(r.prompt) - 1 + len(r.out))
           for r in reqs]
    return seqs, pos


def reference_logits(cell, reqs: list, precision: str = "f32") -> list:
    """The reference's logits (len(out), V) at each request's served
    positions, at ``precision``."""
    from hexabench.reference import mixtral as ref_lm

    seqs, pos = served_positions(reqs)
    return ref_lm.logits_at(cell.config, cell.seed, cell.device, seqs, pos,
                            quant=cell.config["serve"]["quant"],
                            precision=precision)


def compare(ref: list, prog: list, served: list) -> tuple:
    """(numbers, record): ``ref`` and ``prog`` are each request's logits at
    its served positions, ``served`` its served tokens.

    * ``logit_err``: the median over positions of ``|prog - ref| / |ref|``.
      The median, not the mean: the mean parts the port from the fp8
      control by under 3 x (PERF.md gives both readings), since a few
      positions far off in any precision lift it, while a lower precision
      lifts the error at every position;
    * ``token_excess``: the largest ``(ref[best] - ref[t]) - |prog[best] -
      ref[best]| - |prog[t] - ref[t]|`` (at least 0) over served tokens
      ``t``, ``best`` the reference's choice: above 0 only where ``prog``
      did not put ``t`` first.

    ``record`` holds, for the record only, the mean and the 90th
    percentile of the relative error, the largest median error of one
    request, the share of positions whose greedy choices differ and the
    widest gap ``ref[best] - ref[t]``."""
    errs, excess, gaps, flips, per_req = [], [], [], [], []
    for r, p, t in zip(ref, prog, served):
        r = r.double().cpu()
        p = p.double().cpu()
        t = torch.as_tensor(np.asarray(t), dtype=torch.long)[:, None]
        err = (torch.linalg.vector_norm(p - r, dim=-1)
               / torch.linalg.vector_norm(r, dim=-1))
        errs.append(err)
        per_req.append(float(err.median()))
        best = r.argmax(-1, keepdim=True)
        flips.append(best[:, 0] != p.argmax(-1))
        r_best, r_t = r.gather(-1, best)[:, 0], r.gather(-1, t)[:, 0]
        p_best, p_t = p.gather(-1, best)[:, 0], p.gather(-1, t)[:, 0]
        gap = r_best - r_t
        gaps.append(gap)
        excess.append(gap - (p_best - r_best).abs() - (p_t - r_t).abs())
    err = torch.cat(errs)
    numbers = {"logit_err": float(err.median()),
               "token_excess": max(float(torch.cat(excess).max()), 0.0)}
    record = {"logit_err_mean": float(err.mean()),
              "logit_err_p90": float(torch.quantile(err, 0.9)),
              "request_median_max": max(per_req),
              "choice_flips": float(torch.cat(flips).double().mean()),
              "widest_gap": float(torch.cat(gaps).max())}
    return numbers, record


def program_logits(store: dict, reqs: list) -> list:
    """The kept logits of each request's served tokens; None where one is
    missing."""
    try:
        return [torch.stack([store[(r.rid, k)] for k in range(len(r.out))])
                for r in reqs]
    except KeyError:
        return None


def control_numbers(cell, out: dict, precision: str) -> dict:
    """The compared numbers of the control: the reference at ``precision``
    (the nearest below the configuration's) in the program's place, at
    the positions of the same prompts and served tokens, each served token
    the one it puts first."""
    low = reference_logits(cell, out["picked"], precision)
    numbers, out["control_record"] = compare(
        out["ref_logits"], low, [lg.argmax(-1).cpu().numpy() for lg in low])
    return numbers


def run(cell) -> dict:
    from repro_torch.launch.serve import PagedServer
    from repro_torch.parallel.sharding import ParallelConfig

    cfg, mix, dev = cell.config, cell.traffic, cell.device
    eng, sv = mix["engine"], cfg["serve"]
    params = inputs.lm_params(cfg, cell.seed, dev, quant=sv["quant"])
    server = PagedServer(
        lm_config(cfg), ParallelConfig(blk=sv["blk"]),
        num_slots=eng["slots"], page_size=eng["page_size"],
        num_pages=eng["slots"] * eng["pages_per_slot"] + 1,
        max_pages_per_slot=eng["pages_per_slot"], params=params,
        prefill_chunk=eng["prefill_chunk"], device=dev)
    drawn = {}
    undo_capture = capture_logits(drawn)
    try:
        out = _serve(cell, server, drawn)
    finally:
        undo_capture()
    del server, params
    gc.collect()
    if str(dev).startswith("cuda"):
        torch.cuda.empty_cache()
    picked, prog = out["picked"], out.pop("prog_logits")
    numbers = {"logit_err": float("nan"), "token_excess": float("nan")}
    out["record"], out["ref_logits"] = {}, None
    if picked and prog is not None:
        out["ref_logits"] = reference_logits(cell, picked)
        numbers, out["record"] = compare(out["ref_logits"], prog,
                                         [r.out for r in picked])
        print(f"[serve] checked {len(picked)} requests, "
              f"{sum(len(r.out) for r in picked)} served tokens; "
              f"{out['record']}", file=sys.stderr)
    ok, out["checks"] = bench.judge(numbers, cell.limits)
    out["correct"] = ok and out["correct"]
    return out


def _serve(cell, server, drawn: dict) -> dict:
    """Set-up's warm-up steps, the window, the traced steps and the drain;
    the sample to check and the program's logits for it."""
    cfg, mix, dev = cell.config, cell.traffic, cell.device
    loop = ClosedLoop(server, traffic.requests(mix, cell.seed,
                                               cfg["vocab_size"]),
                      mix["clients"])
    for _ in range(mix["warmup_steps"]):
        loop.step()
    bench.sync(dev)
    setup_s = time.perf_counter() - cell.t_start

    loop.phase = "window"
    tokens = 0
    decode_at = len(server.decode_times_s)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < cell.seconds:
        tokens += loop.step()
    bench.sync(dev)
    t1 = time.perf_counter()
    decode_end = len(server.decode_times_s)
    rec = None
    if cell.trace:
        from repro_torch.kernels import ops as kops

        loop.phase = "traced"
        launches, prefill_tokens = [], []
        undo = [
            _wrap(server, "prefill_step", "hexabench.prefill",
                  lambda a, kw: prefill_tokens.append(int(a[2]))),
            _wrap(server, "serve_step", "hexabench.decode"),
            _wrap(kops, "esffn_glu", "hexabench.experts",
                  lambda a, kw: _expert_launch(a, kw, launches))]
        try:
            with devtrace.Capture() as cap:
                for _ in range(mix["trace_steps"]):
                    with torch.profiler.record_function("hexabench.sched"):
                        loop.step()
        finally:
            for u in undo:
                u()
            del undo
    loop.phase, loop.open = "after", False
    window = [s for s in loop.sent.values() if s.phase == "window"]
    t_drain = time.perf_counter()
    while any(s.t_first is None and not s.failed for s in window) \
            and time.perf_counter() - t_drain < mix["drain_s"]:
        loop.step()
    ttft = [s.t_first - s.t_submit for s in window if s.t_first is not None]
    print(f"[serve] {len(window)} requests sent in the window; TTFT s "
          f"{sorted(round(t, 4) for t in ttft)}", file=sys.stderr)
    failed = sum(s.t_first is None or s.failed for s in window)
    if cell.trace:
        rec = {**cap.records, "config": cfg,
               "decode_times_s": server.decode_times_s[decode_at:decode_end],
               "prefill_tokens": sum(prefill_tokens),
               "expert_work": expert_launch_work(launches),
               "window_operations": window_operations(
                   server, loop.sent, cfg, t0, t1),
               "window_host_s": t1 - t0,
               "sched_window": [s[1:] for s in loop.steps
                                if s[0] == "window"],
               "sched_traced": [s[2:] for s in loop.steps
                                if s[0] == "traced"]}
        rec.update(devtrace.summary(rec))
    peak = bench.peak_bytes(dev)
    picked = sample_finished(loop, t0, t1, cell.seed, mix["check"])
    prog = program_logits(drawn, picked)
    drawn.clear()
    return {"correct": failed == 0 and bool(ttft),
            "attempted": len(window), "failed": failed,
            "e2e": {"serve_tokens_per_s": tokens / (t1 - t0),
                    "serve_ttft_mean_ms": (statistics.fmean(ttft) * 1e3
                                           if ttft else float("nan")),
                    "peak_mem_gib": peak / 2 ** 30, "setup_s": setup_s},
            "rec": rec, "peak": peak, "picked": picked, "prog_logits": prog}
