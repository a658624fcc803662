"""Continuous-batching serving engines (counterpart of
``repro.launch.serve``'s ``BatchedServer``, ``PagedServer``,
``reference_stream`` and their CLI, with speculative decoding attached to
the paged engine by ``launch.spec.SpecDecoder``).

``BatchedServer`` (the CLI's default) holds the dense KV rectangle
``(slots, max_seq)`` and spends one full-batch macro-step on every prompt
token; ``reference_stream`` is its batch-1 ground truth. ``PagedServer``
(``--paged``): every occupied slot advances one token per decode
macro-step over the shared KV page pool; admission is by free-page budget
(worst-case pages reserved up front, so FIFO decode never starves the pool
mid-request); prompts prefill in batch-1 chunks interleaved with the
decode steps, with pages granted a chunk's worth at a time and on demand
at decode page boundaries. A request decodes greedily at ``temperature``
0, else by seeded categorical sampling (``next_token``; keys from
``(seed, len(out))`` only, drawn on the logits' device by
``launch.sampling``), so its stream is the same on every engine.
``--quant int8|fp8``
serves block-wise 8-bit expert weights (quantized layer by layer as the
model is drawn) on either engine, and ``--kv-quant int8`` int8 KV pages
with per-row scales (``--paged`` only), each through the kernels' 8-bit
branches.

``--spec-ngram`` / ``--spec-draft ARCH`` (``--paged`` only) verify drafted
tokens in one multi-token forward a slot (``launch.spec``).

Not in this slice (ROADMAP.md): hetero slot and page shares, prefix cache,
disaggregation, fault handling and observability.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch import configs as cfglib
from repro_torch.common import cdiv, resolve_device, torch_dtype, tree_leaves
from repro_torch.launch import sampling
from repro_torch.launch import steps as steps_lib
from repro_torch.models import lm
from repro_torch.parallel.cache import PagePool
from repro_torch.parallel.sharding import ParallelConfig


@dataclass
class Request:
    """One serving request: prompt tokens in, up to ``max_new`` tokens
    out, chosen greedily at ``temperature`` 0 (the default) or drawn
    categorically under the request's own ``seed``."""
    rid: int
    prompt: np.ndarray           # (S_prompt,)
    max_new: int
    out: list = field(default_factory=list)
    temperature: float = 0.0     # 0 = greedy argmax
    seed: int = 0                # per-request sampling seed


def argmax_token(logits_row) -> int:
    """The engine-wide greedy convention: upcast the row to f32, then
    argmax; ties resolve to the lowest index."""
    if isinstance(logits_row, torch.Tensor):
        logits_row = logits_row.detach().float().cpu().numpy()
    row = np.asarray(logits_row, np.float32).reshape(-1)
    return int(np.argmax(row))


def sample_tokens(rows: torch.Tensor, reqs: list) -> np.ndarray:
    """``next_token`` of every row of ``rows`` (B, V) at once, on the rows'
    device, then one copy to the host: row ``i`` for ``reqs[i]`` at step
    ``len(reqs[i].out)`` (a None entry's row is greedy and unused)."""
    return sampling.sample_rows(
        rows, [r.seed if r else 0 for r in reqs],
        [len(r.out) if r else 0 for r in reqs],
        [r.temperature if r else 0.0 for r in reqs]).cpu().numpy()


def next_token(logits_row, req: Request) -> int:
    """Engine-independent next-token selection: greedy at ``temperature
    <= 0`` (``argmax_token``), else a categorical draw from ``row /
    temperature`` at the key ``fold_in(PRNGKey(req.seed), len(req.out))``
    (``launch.sampling``, ``jax.random``'s bits). Keys derive ONLY from
    ``(seed, len(out))``, so a request's stream is a pure function of its
    own logits and seed on every engine, the speculative verify included
    (it appends each accepted token before drawing the next)."""
    if req.temperature <= 0.0:
        return argmax_token(logits_row)
    row = (logits_row if isinstance(logits_row, torch.Tensor)
           else torch.from_numpy(np.asarray(logits_row, np.float32)))
    return int(sample_tokens(row.reshape(1, -1), [req])[0])


def reference_stream(cfg, pcfg, params, req: Request, *, max_seq: int,
                     step=None) -> list[int]:
    """One-request-at-a-time dense-cache reference stream: batch-1 prefill
    (token by token) then decode through ``next_token``, on the device the
    params lie on: the ground truth both batched servers are held to, for
    greedy and sampled requests."""
    device = params["embed"].device
    if step is None:
        step = steps_lib.make_serve_step(cfg, pcfg)
    ref = dataclasses.replace(req, out=[])   # keys follow len(ref.out)
    cache = lm.init_cache(cfg, 1, max_seq, device)

    def feed(tok):
        nonlocal cache
        logits, cache = step(
            params, {"tokens": torch.tensor([[tok]], dtype=torch.int32,
                                            device=device)}, cache)
        return logits[0, -1]

    for tok in ref.prompt:
        logits = feed(int(tok))
    ref.out.append(next_token(logits, ref))
    while len(ref.out) < ref.max_new:
        ref.out.append(next_token(feed(ref.out[-1]), ref))
    return ref.out


def greedy_reference(cfg, pcfg, params, prompt, max_new, *, max_seq: int,
                     step=None) -> list[int]:
    """Greedy ``reference_stream`` of one prompt."""
    return reference_stream(
        cfg, pcfg, params,
        Request(rid=-1, prompt=np.asarray(prompt), max_new=max_new),
        max_seq=max_seq, step=step)


def _check_request(req: Request):
    if len(req.prompt) < 1 or req.max_new < 1:
        raise ValueError(f"request {req.rid}: empty prompt or max_new")


# ---------------------------------------------------------------------------
# dense engine
# ---------------------------------------------------------------------------

@dataclass
class _Slot:
    req: Request
    pos: int = 0        # prompt tokens consumed


class BatchedServer:
    """Dense-cache continuous batching: the KV rectangle ``(num_slots,
    max_seq)`` is allocated up front (the memory over-allocation the paged
    engine exists to kill) and every prompt token of every request costs
    one full-batch macro-step. Only ``valid_slots`` (default: all) are
    schedulable. The cache and lengths live on ``device`` (the GPU unless
    ``device="cpu"``); the schedule lives on the host."""

    def __init__(self, cfg, pcfg, *, num_slots: int, max_seq: int, params,
                 valid_slots: Optional[list] = None, device=None):
        self.cfg, self.pcfg = cfg, pcfg
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params lie on {params['embed'].device}, the "
                             f"server runs on {self.device}")
        self.num_slots = num_slots
        self.max_seq = max_seq
        self.params = params
        self.cache = lm.init_cache(cfg, num_slots, max_seq, self.device)
        self.serve_step = steps_lib.make_serve_step(cfg, pcfg)
        self.slots: list[Optional[_Slot]] = [None] * num_slots
        self.queue: deque[Request] = deque()
        self.free = sorted(valid_slots if valid_slots is not None
                           else range(num_slots), reverse=True)
        self.decode_times_s: list = []
        self.ttft_s: dict = {}           # rid -> first-token latency
        self.admissions = 0
        self._run_t0 = 0.0

    def kv_bytes(self) -> int:
        """Device bytes of the dense KV rectangle."""
        return lm.cache_bytes(self.cache)

    def submit(self, req: Request):
        _check_request(req)
        if len(req.prompt) + req.max_new - 1 > self.max_seq:
            raise ValueError(
                f"request {req.rid} needs {len(req.prompt) + req.max_new - 1}"
                f" cache rows > max_seq {self.max_seq}")
        self.queue.append(req)

    def _admit(self):
        while self.free and self.queue:
            slot = self.free.pop()
            req = self.queue.popleft()
            self.cache = lm.reset_slot(self.cfg, self.cache, slot)
            self.slots[slot] = _Slot(req)
            self.admissions += 1

    def _macro_step(self) -> list[Request]:
        tokens = np.zeros((self.num_slots, 1), np.int32)
        active = np.zeros((self.num_slots,), bool)
        for slot, st in enumerate(self.slots):
            if st is None:
                continue
            active[slot] = True
            tokens[slot, 0] = (st.req.prompt[st.pos]
                               if st.pos < len(st.req.prompt)
                               else st.req.out[-1])
        t0 = time.perf_counter()
        logits, self.cache = self.serve_step(
            self.params,
            {"tokens": torch.from_numpy(tokens).to(self.device),
             "active": torch.from_numpy(active).to(self.device)},
            self.cache)
        emit = [st.req if st is not None
                and st.pos + 1 >= len(st.req.prompt) else None
                for st in self.slots]
        nxt = sample_tokens(logits[:, -1], emit)
        self.decode_times_s.append(time.perf_counter() - t0)
        done = []
        for slot, st in enumerate(self.slots):
            if st is None:
                continue
            st.pos += 1
            if st.pos >= len(st.req.prompt):
                if not st.req.out:
                    self.ttft_s[st.req.rid] = \
                        time.perf_counter() - self._run_t0
                st.req.out.append(int(nxt[slot]))
                if len(st.req.out) >= st.req.max_new:
                    done.append(st.req)
                    self.slots[slot] = None
                    self.free.append(slot)
        return done

    def run(self, max_steps: int = 100000) -> list[Request]:
        """Drive admission + macro-steps until every request has finished."""
        done: list[Request] = []
        steps = 0
        self._run_t0 = time.perf_counter()
        while (self.queue or any(s is not None for s in self.slots)) \
                and steps < max_steps:
            self._admit()
            done.extend(self._macro_step())
            steps += 1
        return done


# ---------------------------------------------------------------------------
# paged engine
# ---------------------------------------------------------------------------

@dataclass
class _PagedSlot:
    req: Request
    order: int           # admission sequence (FIFO prefill priority)
    reserved: int        # worst-case pages reserved from the pool
    pages: list = field(default_factory=list)  # phys page per logical page
    pos: int = 0         # prompt tokens consumed
    length: int = 0      # tokens resident in the paged cache
    reclaimed: int = 0   # leading logical pages released behind the window
    allocated: int = 0   # pool.alloc calls (reservations consumed)


class PagedServer:
    """Continuous batching over the paged KV cache.

    A request is admitted only when its worst-case page count
    ``ceil((prompt + max_new - 1) / page_size)`` can be reserved; prefill
    grants a chunk's worth of pages before each ``prefill_chunk``-token
    batch-1 chunk, decode one page per boundary crossing; on all-windowed
    stacks pages wholly behind the window return to the pool mid-request.
    The K/V pools and lengths live on ``device`` (the GPU unless
    ``device="cpu"``); tables and the schedule live on the host.
    ``kv_quant="int8"``: the pools hold int8 rows with per-(row, kv head)
    f32 scales, and admission budgets in the smaller int8 page bytes.
    A ``launch.spec.SpecDecoder`` attaches itself as ``spec`` and then runs
    every decode tick; ``trace`` records its ``("spec_verify", rid, slot,
    n_valid, accepted)`` and ``("rollback", rid, slot, n)`` events.
    """

    def __init__(self, cfg, pcfg, *, num_slots: int, page_size: int,
                 num_pages: int, max_pages_per_slot: int, params,
                 prefill_chunk: int = 16, kv_quant=None, device=None):
        self.cfg, self.pcfg = cfg, pcfg
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"params lie on {params['embed'].device}, the "
                             f"server runs on {self.device}")
        self.num_slots = num_slots
        self.page_size = page_size
        self.max_pages_per_slot = max_pages_per_slot
        self.prefill_chunk = prefill_chunk
        self.params = params
        self.kv_quant = None if kv_quant in (None, "none") else kv_quant
        self.cache = lm.init_paged_cache(cfg, num_slots, num_pages, page_size,
                                         self.device, kv_quant=self.kv_quant)
        self.page_bytes = lm.paged_kv_page_bytes(cfg, page_size,
                                                 kv_quant=self.kv_quant)
        self.pool = PagePool(num_pages, page_bytes=self.page_bytes)
        # Window page reclamation: when EVERY attention layer is windowed,
        # a page wholly behind the window is dead and returns to the pool.
        self.reclaim_window = (
            cfg.window if cfg.window > 0 and all(
                cfg.attn_kind(i) == "local" for i in range(cfg.num_layers))
            else None)
        self.table = np.zeros((num_slots, max_pages_per_slot), np.int32)
        self.serve_step = steps_lib.make_paged_serve_step(cfg, pcfg, page_size)
        self.prefill_step = steps_lib.make_paged_prefill_step(cfg, pcfg,
                                                              page_size)
        self.slots: list[Optional[_PagedSlot]] = [None] * num_slots
        self.queue: deque[Request] = deque()
        self.free = sorted(range(num_slots), reverse=True)
        self.decode_times_s: list = []
        self.ttft_s: dict = {}           # rid -> first-token latency
        self.admissions = 0
        self.spec = None                 # a SpecDecoder, when attached
        self.trace: list[tuple] = []     # (name, *args) scheduler events
        self._order = 0
        self._run_t0 = 0.0

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    def _need_pages(self, req: Request) -> int:
        # cache rows written = prompt + fed-back outputs (the last
        # generated token is never fed back)
        return cdiv(len(req.prompt) + req.max_new - 1, self.page_size)

    def submit(self, req: Request):
        _check_request(req)
        need = self._need_pages(req)
        if need > min(self.max_pages_per_slot, self.pool.num_pages - 1):
            raise ValueError(
                f"request {req.rid} needs {need} pages > max_pages_per_slot "
                f"{self.max_pages_per_slot} or the pool's "
                f"{self.pool.num_pages - 1} allocatable pages")
        self.queue.append(req)

    # -- scheduling ticks -----------------------------------------------------

    def _admit(self):
        """Strict FIFO: the queue head admits as soon as a slot is free and
        its worst-case pages can be reserved; nothing overtakes it."""
        while self.queue and self.free:
            req = self.queue[0]
            need = self._need_pages(req)
            if not self.pool.try_reserve(need):
                return
            self.queue.popleft()
            slot = self.free.pop()
            self.cache = lm.reset_slot(self.cfg, self.cache, slot)
            self.slots[slot] = _PagedSlot(req, self._order, reserved=need)
            self._order += 1
            self.admissions += 1
            self.table[slot, :] = 0

    def _ensure_pages(self, slot: int, st: _PagedSlot, length: int):
        """Back every position below ``length`` with a physical page drawn
        from the request's admission reservation."""
        while (length - 1) // self.page_size >= len(st.pages):
            st.pages.append(self.pool.alloc())
            st.allocated += 1
            self.table[slot, len(st.pages) - 1] = st.pages[-1]

    def _reclaim(self, slot: int, st: _PagedSlot):
        """Release pages wholly behind the attention window; the table
        entry drops to the sink (attention masks those positions)."""
        if self.reclaim_window is None:
            return
        dead = (st.length - self.reclaim_window) // self.page_size
        while st.reclaimed < dead:
            j = st.reclaimed
            self.pool.release([st.pages[j]])
            st.pages[j] = 0
            self.table[slot, j] = 0
            st.reclaimed += 1

    def _rollback(self, slot: int, n: int):
        """Un-write the slot's last ``n`` speculative cache rows by
        truncation only: shrink its device length (``lm.rollback_slot``;
        attention masks every row past it), pop the tail pages that no
        longer back a row back to the request's own reservation
        (``PagePool.rollback``, never the free budget) and zero their
        table entries. The sampling key needs no rewind: keys derive from
        ``(seed, len(out))`` and rejected tokens were never appended."""
        st = self.slots[slot]
        if n <= 0:
            return
        new_len = st.length - n
        assert new_len >= len(st.req.prompt), (new_len, len(st.req.prompt))
        if self.reclaim_window is not None and st.reclaimed:
            # reclamation only ever runs at committed lengths (the spec
            # tick reclaims AFTER rollback), so no reclaimed page can
            # re-enter the rolled-back window
            assert st.reclaimed * self.page_size <= max(
                new_len - self.reclaim_window, 0), \
                "rollback would rewind into window-reclaimed pages"
        keep = cdiv(new_len, self.page_size)
        dropped = []
        while len(st.pages) > keep:
            p = st.pages.pop()
            self.table[slot, len(st.pages)] = 0
            if p != 0:
                dropped.append(p)
        if dropped:
            self.pool.rollback(dropped)
            st.allocated -= len(dropped)
        self.cache = lm.rollback_slot(self.cfg, self.cache, slot, new_len)
        st.length = new_len
        self.trace.append(("rollback", st.req.rid, slot, n))

    def _finish(self, slot: int, st: _PagedSlot, done: list):
        done.append(st.req)
        self.pool.release([p for p in st.pages if p != 0],
                          unused_reserved=st.reserved - st.allocated)
        self.table[slot, :] = 0
        self.slots[slot] = None
        self.free.append(slot)
        if self.spec is not None:
            self.spec.forget(st.req.rid)

    def _prefill_tick(self, done: list) -> bool:
        """One chunk of the FIFO-oldest prefilling request."""
        cand = [(st.order, slot, st) for slot, st in enumerate(self.slots)
                if st is not None and st.pos < len(st.req.prompt)]
        if not cand:
            return False
        _, slot, st = min(cand)
        n = min(self.prefill_chunk, len(st.req.prompt) - st.pos)
        self._ensure_pages(slot, st, st.length + n)
        toks = np.zeros((self.prefill_chunk,), np.int32)
        toks[:n] = st.req.prompt[st.pos: st.pos + n]
        last, self.cache = self.prefill_step(
            self.params, self._tensor(toks), n, slot,
            self._tensor(self.table[slot]), self.cache)
        st.pos += n
        st.length += n
        self._reclaim(slot, st)
        if st.pos == len(st.req.prompt):
            st.req.out.append(next_token(last, st.req))
            self.ttft_s[st.req.rid] = time.perf_counter() - self._run_t0
            if len(st.req.out) >= st.req.max_new:
                self._finish(slot, st, done)
        return True

    def _decode_tick(self, done: list) -> bool:
        """One decode macro-step over every slot past prefill (with a
        ``spec`` attached, one speculative verify round a slot)."""
        if self.spec is not None:
            return self.spec.decode_tick(done)
        dec = [(slot, st) for slot, st in enumerate(self.slots)
               if st is not None and st.pos >= len(st.req.prompt)]
        if not dec:
            return False
        tokens = np.zeros((self.num_slots, 1), np.int32)
        active = np.zeros((self.num_slots,), bool)
        for slot, st in dec:
            self._ensure_pages(slot, st, st.length + 1)
            tokens[slot, 0] = st.req.out[-1]
            active[slot] = True
        t0 = time.perf_counter()
        logits, self.cache = self.serve_step(
            self.params,
            {"tokens": self._tensor(tokens),
             "page_table": self._tensor(self.table),
             "active": self._tensor(active)},
            self.cache)
        emit = [None] * self.num_slots
        for slot, st in dec:
            emit[slot] = st.req
        nxt = sample_tokens(logits[:, -1], emit)
        self.decode_times_s.append(time.perf_counter() - t0)
        for slot, st in dec:
            st.length += 1
            st.req.out.append(int(nxt[slot]))
            self._reclaim(slot, st)
            if len(st.req.out) >= st.req.max_new:
                self._finish(slot, st, done)
        return True

    def run(self, max_steps: int = 100000) -> list[Request]:
        """Drive admission + ticks until every request has finished."""
        done: list[Request] = []
        steps = 0
        self._run_t0 = time.perf_counter()
        while (self.queue or any(s is not None for s in self.slots)) \
                and steps < max_steps:
            self._admit()
            advanced = self._prefill_tick(done)
            advanced |= self._decode_tick(done)
            if not advanced and not self.queue:
                break
            steps += 1
        return done

    def stats(self) -> dict:
        return {**self.pool.stats(), "admissions": self.admissions}


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


def _unquantized_bytes(params: dict, dtype: torch.dtype) -> int:
    """The bytes ``params`` would take with its 8-bit expert payloads in
    ``dtype`` and no scales: the full-precision tree's."""
    itemsize = torch.empty((), dtype=dtype).element_size()
    total = _tree_bytes(params)
    for layer in params["layers"]:
        for name, t in layer["ffn"].items():
            if name.endswith("_scale"):
                payload = layer["ffn"][name[:-len("_scale")]]
                total += payload.numel() * (itemsize - 1) - \
                    t.numel() * t.element_size()
    return total

def main(argv=None):
    """CLI entry point: continuous batching of random prompts through a
    seeded random-weight model, on the dense engine or (``--paged``) the
    paged one."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--paged", action="store_true",
                    help="serve from the paged KV pool (default: the dense "
                         "(slots, max_seq) cache of BatchedServer)")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pages", type=int, default=0,
                    help="shared pool size incl. the sink page "
                         "(0 -> slots * ceil(max_seq/page)/2 + 1)")
    ap.add_argument("--prefill-chunk", type=int, default=16)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights")
    ap.add_argument("--quant", default="none",
                    choices=["none", "int8", "fp8"],
                    help="serve block-wise int8/fp8 expert weights through "
                         "the kernels' 8-bit branches")
    ap.add_argument("--kv-quant", default="none", choices=["none", "int8"],
                    help="store paged-KV pages as int8 rows + per-row "
                         "scales (--paged only)")
    ap.add_argument("--spec-ngram", action="store_true",
                    help="speculative decoding with self-speculative "
                         "n-gram drafting from each request's own token "
                         "history, no draft model (--paged only)")
    ap.add_argument("--spec-draft", default=None, metavar="ARCH",
                    help="speculative decoding with a draft model drawn "
                         "from --seed + 1, resolved with the same --smoke "
                         "switch as --arch (--paged only): an "
                         "all-attention, non-windowed config the port "
                         "serves (qwen3-moe-30b-a3b); gemma-2b raises "
                         "NotImplementedError until dense FFN layers are "
                         "ported")
    ap.add_argument("--spec-k", type=int, default=4,
                    help="draft length per verify round: up to k drafted "
                         "tokens + 1 correction commit per forward")
    args = ap.parse_args(argv)
    if (args.spec_ngram or args.spec_draft) and not args.paged:
        ap.error("--spec-ngram/--spec-draft require --paged")
    if args.spec_ngram and args.spec_draft:
        ap.error("--spec-ngram and --spec-draft are mutually exclusive")
    if args.kv_quant != "none" and not args.paged:
        ap.error("--kv-quant requires --paged")
    device = resolve_device(args.device)
    cfg = (cfglib.get_smoke_config(args.arch) if args.smoke
           else cfglib.get_config(args.arch))
    pcfg = ParallelConfig(blk=16)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    if args.quant != "none":
        # quantized layer by layer as drawn: the full-precision tree (61 GB
        # at qwen3-moe-30b-a3b's width) never sits beside its int8 copy
        params = lm.init_params(cfg, generator=gen, device=device,
                                quant=args.quant)
        before = _unquantized_bytes(params, torch_dtype(cfg.dtype))
        print(f"[serve] expert weights -> {args.quant}: params "
              f"{before / 1e6:.1f}MB -> "
              f"{_tree_bytes(params) / 1e6:.1f}MB")
    else:
        params = lm.init_params(cfg, generator=gen, device=device)
    if args.paged:
        pages = args.pages or (
            args.slots * cdiv(args.max_seq, args.page_size) // 2 + 1)
        server = PagedServer(
            cfg, pcfg, num_slots=args.slots, page_size=args.page_size,
            num_pages=pages,
            max_pages_per_slot=cdiv(args.max_seq, args.page_size),
            params=params, prefill_chunk=args.prefill_chunk,
            kv_quant=args.kv_quant, device=device)
        if args.spec_ngram or args.spec_draft:
            # spec imports this module (the shared sampling convention),
            # so it is imported here, never at module level
            from repro_torch.launch import spec as spec_lib
            if args.spec_draft:
                dcfg = (cfglib.get_smoke_config(args.spec_draft)
                        if args.smoke else cfglib.get_config(args.spec_draft))
                dparams = lm.init_params(
                    dcfg, device=device, generator=torch.Generator(
                        device=device).manual_seed(args.seed + 1))
                drafter = spec_lib.ModelDrafter(dcfg, pcfg, dparams,
                                                max_seq=args.max_seq,
                                                device=device)
            else:
                drafter = spec_lib.NGramDrafter()
            spec_lib.SpecDecoder(server, drafter, k=args.spec_k)
    else:
        server = BatchedServer(cfg, pcfg, num_slots=args.slots,
                               max_seq=args.max_seq, params=params,
                               device=device)
    rng = np.random.default_rng(0)
    for i in range(args.requests):
        server.submit(Request(
            rid=i,
            prompt=rng.integers(0, cfg.vocab_size, size=8).astype(np.int32),
            max_new=args.max_new))
    t0 = time.time()
    done = server.run()
    dt = time.time() - t0
    total_tokens = sum(len(r.out) for r in done)
    print(f"[serve] {len(done)} requests, {total_tokens} tokens "
          f"in {dt:.2f}s ({total_tokens / max(dt, 1e-9):.1f} tok/s)")
    if server.decode_times_s:
        ts = np.asarray(server.decode_times_s[1:] or server.decode_times_s)
        print(f"[serve] measured decode step: median "
              f"{np.median(ts) * 1e3:.1f}ms p90 "
              f"{np.percentile(ts, 90) * 1e3:.1f}ms over {len(ts)} steps")
    if args.paged:
        st = server.stats()
        print(f"[serve] page pool: {st['peak_in_use_pages']} peak pages "
              f"({st['peak_in_use_bytes'] / 1024:.1f} KiB KV resident, "
              f"{server.page_bytes} B a {server.kv_quant or cfg.dtype} page) "
              f"of {st['num_pages'] - 1} allocatable; {st['total_allocs']} "
              f"allocs, leak-free={st['free_pages'] == st['num_pages'] - 1}")
        if server.spec is not None:
            sp = server.spec.stats()
            print(f"[serve] speculative: {sp['rounds']} verify rounds, "
                  f"{sp['accepted_drafts']}/{sp['drafted']} drafts "
                  f"accepted ({sp['acceptance_rate']:.0%}), "
                  f"{sp['rollback_tokens']} rows rolled back")
    else:
        print(f"[serve] dense KV cache: {server.kv_bytes() / 1024:.1f} KiB "
              f"({args.slots} slots, max_seq {args.max_seq})")
    for r in done[:3]:
        print(f"  req {r.rid}: {r.out[:8]}...")
    return done


if __name__ == "__main__":
    main()
