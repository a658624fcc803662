"""Speculative decoding on the paged engine (counterpart of
``repro.launch.spec``).

Decode moves the whole weight set (and the slot's KV pages) to emit one
token a slot. Verifying ``k`` drafted tokens in one chunk-extension paged
forward (``launch.steps.make_paged_score_step``) spreads that traffic over
up to ``k + 1`` committed tokens.

The acceptance rule is **exact-match replay**: each verify row ``i`` holds
the logits a sequential decode would have produced at that position, the
engine draws from it with ``launch.serve.next_token``'s convention (keys
from ``(seed, len(out))`` only, so row ``i`` draws at step ``len(out) +
i`` exactly as the sequential engine would), and drafting goes on only
while the drawn token equals the drafted one. Accepted streams are
therefore token-identical to the non-speculative paged engine and to the
batch-1 ``reference_stream``, greedy and seeded-temperature alike: the
draft only decides how many sequential steps collapse into one forward.

Rejection rolls back by truncation only: ``PagedServer._rollback`` shrinks
the slot's device length, returns the tail pages no row uses any more to
the request's own reservation (``PagePool.rollback``), and the key needs
no rewind because rejected tokens were never appended to ``out``.
Recurrent stacks cannot rewind their token-wise state, so ``SpecDecoder``
refuses them at construction (``make_paged_score_step`` raises).

Not ported here (ROADMAP.md A.6): the metrics registry and trace spans,
and fault injection. Non-finite verify logits raise ``RuntimeError``
naming the slot (the JAX engine aborts and retries the slot; retries are
not ported).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.common import resolve_device
from repro_torch.launch import sampling
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.serve import argmax_token
from repro_torch.models import lm


class NGramDrafter:
    """Self-speculative n-gram drafting from the request's own history:
    find the most recent PRIOR occurrence of the trailing ``n``-gram in
    ``prompt + out`` and propose the tokens that followed it. No draft
    model and no extra memory traffic. An empty draft degrades the verify
    round to a plain one-token decode through the same score step."""

    def __init__(self, n: int = 3):
        if n < 1:
            raise ValueError(f"n-gram order must be >= 1, got {n}")
        self.n = n

    def draft(self, history: np.ndarray, k: int, rid: int = -1) -> list:
        """Propose up to ``k`` continuation tokens after ``history``,
        longest-matching suffix first (order ``n`` down to 1); ``[]`` when
        no prior occurrence exists. Among occurrences of one order the
        MOST RECENT one with a full ``k``-token continuation wins; where
        every continuation is cut short by the end of history, the
        longest one is proposed."""
        h = np.asarray(history)
        if k <= 0:
            return []
        for n in range(min(self.n, len(h) - 1), 0, -1):
            pat = h[-n:]
            best: list = []
            for i in range(len(h) - n - 1, -1, -1):
                if np.array_equal(h[i:i + n], pat):
                    cont = h[i + n:i + n + k]
                    if len(cont) == k:
                        return [int(t) for t in cont]
                    if len(cont) > len(best):
                        best = [int(t) for t in cont]
            if best:
                return best
        return []


class ModelDrafter:
    """Draft-model drafting: a dense-cache model greedily proposes ``k``
    tokens a verify round. Per request it keeps a batch-1 dense cache
    (``lm.init_cache``, ``steps.make_serve_step``): each ``draft`` call
    catches the cache up on the tokens the target committed since the
    last round, decodes ``k`` greedy tokens (``argmax_token``, the
    target's convention, so a draft of the target's own config and
    params reaches full acceptance under greedy), then truncates its
    length back to the committed history so rejected draft rows vanish.
    Hence only all-attention, non-windowed configs: a rolling window
    buffer and recurrent state cannot rewind. The config must also be one
    the port serves (``lm.check_supported``): dense FFN layers (gemma-2b)
    raise ``NotImplementedError``. The caches live on ``device`` (the GPU
    unless ``device="cpu"``)."""

    def __init__(self, cfg, pcfg, params, *, max_seq: int, device=None):
        if any(cfg.layer_kind(i) != "attn" for i in range(cfg.num_layers)):
            raise ValueError(
                "ModelDrafter requires an all-attention draft config: "
                "recurrent draft state cannot rewind past rejected drafts")
        if cfg.window > 0 and any(cfg.attn_kind(i) == "local"
                                  for i in range(cfg.num_layers)):
            raise ValueError(
                "ModelDrafter requires a non-windowed draft config: the "
                "rolling local-attention cache cannot truncate safely")
        if cfg.num_codebooks > 1:
            raise ValueError("ModelDrafter does not support codebook heads")
        lm.check_supported(cfg)
        self.device = resolve_device(device)
        if params["embed"].device.type != self.device.type:
            raise ValueError(f"draft params lie on {params['embed'].device}, "
                             f"the drafter runs on {self.device}")
        self.cfg, self.pcfg = cfg, pcfg
        self.params = params
        self.max_seq = max_seq
        self.step = steps_lib.make_serve_step(cfg, pcfg)
        self._state: dict = {}   # rid -> [cache, resident length]

    def _feed(self, cache, tok: int):
        return self.step(self.params, {"tokens": torch.tensor(
            [[tok]], dtype=torch.int32, device=self.device)}, cache)

    def draft(self, history: np.ndarray, k: int, rid: int = -1) -> list:
        """Catch the request's draft cache up on ``history`` and greedily
        decode up to ``k`` proposal tokens (empty when the draft cache
        cannot hold them)."""
        hist = np.asarray(history)
        k = min(k, self.max_seq - len(hist))
        if k <= 0:
            return []
        if rid not in self._state:
            self._state[rid] = [
                lm.init_cache(self.cfg, 1, self.max_seq, self.device), 0]
        cache, resident = self._state[rid]
        logits = None
        for tok in hist[resident:]:
            logits, cache = self._feed(cache, int(tok))
        draft = [argmax_token(logits[0, -1])]
        for _ in range(k - 1):
            logits, cache = self._feed(cache, draft[-1])
            draft.append(argmax_token(logits[0, -1]))
        # truncate the draft rows: the next round's catch-up feeds from
        # the committed history, whatever the target accepted
        cache["len"][0] = len(hist)
        self._state[rid] = [cache, len(hist)]
        return draft

    def drop(self, rid: int) -> None:
        """Free the per-request draft cache (when the request finishes)."""
        self._state.pop(rid, None)


class SpecDecoder:
    """Drive speculative draft/verify rounds on a ``PagedServer``.
    Constructing one attaches it (``server.spec``); the server's decode
    tick then runs here. Each round, per slot past prefill:

    1. ask the drafter for up to ``k`` tokens after ``prompt + out``
       (capped so the round never writes past the admitted worst-case
       length);
    2. score ``[out[-1]] + draft`` in ONE chunk-extension paged forward
       (``make_paged_score_step``), pages granted from the slot's
       reservation as at a decode boundary;
    3. draw every row on the device (row ``i`` at step ``len(out) + i``)
       and copy the tokens to the host once; append them while each
       equals the draft;
    4. roll rejected rows back by truncation (``PagedServer._rollback``),
       and only then window-reclaim at the committed length.

    ``round_times_s`` holds each round's wall time (one slot, ending with
    the tokens on the host)."""

    def __init__(self, server, drafter, k: int = 4):
        if k < 1:
            raise ValueError(f"draft length k must be >= 1, got {k}")
        # refuses recurrent stacks and codebook heads
        self._score_step = steps_lib.make_paged_score_step(
            server.cfg, server.pcfg, server.page_size)
        self.server = server
        self.drafter = drafter
        self.k = k
        self.chunk = k + 1
        self.rounds = 0
        self.drafted = 0            # draft tokens scored
        self.accepted_drafts = 0    # draft tokens that matched the draw
        self.rollback_tokens = 0    # speculative rows truncated away
        self.round_times_s: list = []
        server.spec = self

    def stats(self) -> dict:
        """Counters, and the fraction of drafted tokens accepted."""
        return {
            "rounds": self.rounds,
            "drafted": self.drafted,
            "accepted_drafts": self.accepted_drafts,
            "rollback_tokens": self.rollback_tokens,
            "acceptance_rate": self.accepted_drafts / max(self.drafted, 1),
        }

    def decode_tick(self, done: list) -> bool:
        """One speculative round over every slot past prefill: the
        replacement of ``PagedServer._decode_tick``'s macro-step."""
        srv = self.server
        dec = [(slot, st) for slot, st in enumerate(srv.slots)
               if st is not None and st.pos >= len(st.req.prompt)]
        if not dec:
            return False
        t0 = time.perf_counter()
        for slot, st in dec:
            self._verify_round(slot, st, done)
        srv.decode_times_s.append(time.perf_counter() - t0)
        return True

    def _verify_round(self, slot: int, st, done: list) -> int:
        srv = self.server
        req = st.req
        t0 = time.perf_counter()
        # rows stay inside the admitted worst case (prompt + max_new - 1
        # cache rows): budget - 1 drafts at most, since row 0 is always
        # the pending fed-back token
        budget = req.max_new - len(req.out)
        draft: list = []
        if budget > 1:
            history = np.concatenate([np.asarray(req.prompt, np.int64),
                                      np.asarray(req.out, np.int64)])
            draft = [int(t) for t in
                     self.drafter.draft(history, min(self.k, budget - 1),
                                        req.rid)][:budget - 1]
        if any(not 0 <= t < srv.cfg.vocab_size for t in draft):
            raise ValueError(f"slot {slot}: draft {draft} leaves the "
                             f"vocabulary of {srv.cfg.vocab_size}")
        n_valid = 1 + len(draft)
        self.drafted += len(draft)
        srv._ensure_pages(slot, st, st.length + n_valid)
        toks = np.zeros((self.chunk,), np.int32)
        toks[0] = req.out[-1]
        toks[1:n_valid] = draft
        logits, srv.cache = self._score_step(
            srv.params, srv._tensor(toks), n_valid, slot,
            srv._tensor(srv.table[slot]), srv.cache)
        st.length += n_valid
        rows = logits[:n_valid]
        n0 = len(req.out)
        drawn = sampling.sample_rows(rows, [req.seed] * n_valid,
                                     range(n0, n0 + n_valid),
                                     [req.temperature] * n_valid)
        host = torch.cat([drawn, torch.isfinite(rows).all().long()[None]])
        host = host.cpu().numpy()
        if not host[-1]:
            raise RuntimeError(f"slot {slot} (request {req.rid}): "
                               f"non-finite verify logits")
        accepted = 0
        finished = False
        for i in range(n_valid):
            tok = int(host[i])
            req.out.append(tok)
            accepted = i + 1
            if len(req.out) >= req.max_new:
                finished = True
                break
            if i < len(draft) and tok != draft[i]:
                break   # the drawn token is the correction; every row
                        # past it was speculation
        self.rounds += 1
        self.accepted_drafts += accepted - 1
        srv.trace.append(("spec_verify", req.rid, slot, n_valid, accepted))
        if finished:
            srv._finish(slot, st, done)
        else:
            n_reject = n_valid - accepted
            self.rollback_tokens += n_reject
            srv._rollback(slot, n_reject)
            # reclamation only ever sees COMMITTED lengths: reclaiming at
            # the speculative length could free pages the rolled-back
            # window still reads (``_rollback``'s assert pins the order)
            srv._reclaim(slot, st)
        self.round_times_s.append(time.perf_counter() - t0)
        return accepted

    def forget(self, rid: int) -> None:
        """Drop per-request drafter state (called from
        ``PagedServer._finish``)."""
        drop = getattr(self.drafter, "drop", None)
        if drop is not None:
            drop(rid)
