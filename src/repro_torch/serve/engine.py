"""Batched serving engine of the port: incremental continuous batching +
chunked decode (the dense fast path of ``repro/serve/engine.py``).

  * **Incremental admission** — an admission wave prefills ONLY the
    admitted requests (``api.prefill_slot``: one prefill whose KV rows are
    written into the live batch cache).  Per-slot valid lengths live in a
    device-resident ``seq_lens`` vector.
  * **Paged decode attention** — each step reads only a slot's valid cache
    prefix (the CUDA decode kernel on the card).
  * **Multi-step decode** — ``api.decode_n`` advances ``chunk`` steps with
    on-device token selection and done-masking; the host reads the tokens
    once per chunk.  Greedy outputs are bitwise identical for any chunk.

Kept from the reference on purpose: prompts are left-padded with token 0
to ``prompt_len`` and the pads are attended as real tokens (``seq_lens`` is
``prompt_len`` after admission); a wave is padded to ``slots`` rows whose
out-of-range slot index drops them (explicitly here, where JAX drops
out-of-bounds scatter updates).

Not ported yet: the pooled prefix-shared KV cache (``kv_block > 0``), int8
weights (``quant="int8"``), the whisper legacy path and the ``obs=``
telemetry hookup; the first three raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.models import transformer as TF


@dataclasses.dataclass(frozen=True)
class SliceSpec:
    """Serving-session shape: the envelope of one engine (the fields of
    ``repro.serve.engine.SliceSpec`` the dense path reads, and the two
    that select paths not ported yet).

    ``chunk`` is the decode tokens advanced per host sync (1 = per-token,
    same numerics)."""
    slots: int = 4                  # decode batch width
    max_len: int = 256              # KV-cache length per slot
    prompt_len: int = 32            # padded prefill length
    greedy: bool = True
    chunk: int = 8                  # decode steps per host sync
    kv_block: int = 0               # pooled KV block size (0 = dense cache;
                                    # pooled is not ported yet)
    quant: str = "none"             # weight storage: "none" | "int8"
                                    # (int8 is not ported yet)

    def __post_init__(self):
        assert self.slots >= 1 and 0 < self.prompt_len <= self.max_len, self
        assert self.chunk >= 1, self
        assert self.quant in ("none", "int8"), self


@dataclasses.dataclass(eq=False)
class Request:
    """One serving request (identity equality, as in the reference)."""
    rid: int
    prompt: np.ndarray              # (prompt_len,) int32
    max_new_tokens: int
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    t_submit: float = 0.0
    t_first: Optional[float] = None
    t_done: Optional[float] = None


def _pct(xs: List[float], q: float) -> float:
    return float(np.percentile(np.asarray(xs), q)) if xs else 0.0


class ServeEngine:
    """Continuous-batching serving engine on one device.

    Args:
      cfg: model config (dense family).
      params: param tree (JAX layout, see ``repro_torch.interop``) already
        on ``device``.
      spec: `SliceSpec` serving envelope.
      device: "cuda" by default; raises without a card unless "cpu".
    """

    def __init__(self, cfg: ModelConfig, params,
                 spec: Optional[SliceSpec] = None, *, device="cuda"):
        spec = spec or SliceSpec()
        self.device = api.resolve_device(device)
        if spec.kv_block:
            raise NotImplementedError(
                "pooled prefix-shared KV (SliceSpec.kv_block > 0) waits for "
                "ROADMAP.md queue 1, item 6")
        if spec.quant != "none":
            raise NotImplementedError(
                "int8 weights (SliceSpec.quant='int8') wait for ROADMAP.md "
                "queue 1, item 4")
        if cfg.family == "audio":
            raise NotImplementedError(
                "the whisper legacy full-batch path waits for ROADMAP.md "
                "queue 1, item 11")
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} waits for ROADMAP.md queue 1, item 11")
        pdev = params["embed"].device
        if pdev.type != self.device.type:
            raise ValueError(f"params live on {pdev}, the engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.params = params
        self.spec = spec
        self.slots = spec.slots
        self.max_len = spec.max_len
        self.prompt_len = spec.prompt_len
        self.greedy = spec.greedy
        self.queue: List[Request] = []        # every request, for stats
        self.pending: List[Request] = []      # submitted, not yet admitted
        self._next_rid = 0
        self.active: List[Optional[Request]] = [None] * spec.slots
        self.cache = None
        zeros = lambda: torch.zeros((spec.slots,), dtype=torch.int32,
                                    device=self.device)
        self.last_tokens = zeros()
        self.seq_lens = zeros()
        # per-slot sampling salt = rid of the request occupying the slot
        self.sample_salt = zeros()
        self.chunk_lat_s: List[float] = []
        self._chunk_ema: Optional[float] = None
        self._steps = 0
        self._sample_seed = spec.slots        # the reference's PRNGKey(slots)
        # telemetry counters, plain ints under the reference's names
        self.prefill_flops_proxy = 0
        self.kv_prompt_tokens = 0
        self.kv_shared_tokens = 0
        self.kv_migrated_shared_blocks = 0
        self.kv_migrated_suffix_blocks = 0

    # -- request lifecycle ----------------------------------------------------

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 32) -> Request:
        """Enqueue one prompt; returns its `Request` handle.  The prompt is
        truncated to the last `spec.prompt_len` tokens at prefill."""
        r = Request(rid=self._next_rid, prompt=np.asarray(prompt, np.int32),
                    max_new_tokens=max_new_tokens, t_submit=time.time())
        self._next_rid += 1
        self.queue.append(r)
        self.pending.append(r)
        return r

    def _admit(self) -> bool:
        """Fill empty slots from the queue with ONE prefill over a wave
        padded to ``slots`` rows; padding rows carry the out-of-range slot
        index ``slots`` and are dropped."""
        if not self.pending:
            return False
        free = [i for i, a in enumerate(self.active)
                if a is None or a.done]
        n = min(len(self.pending), len(free))
        if n == 0:
            return False
        if self.cache is None:
            self.cache = api.init_cache(self.cfg, self.slots, self.max_len,
                                        device=self.device)
        admitted = self.pending[:n]
        del self.pending[:n]
        slots = np.full((self.slots,), self.slots, np.int64)  # padding rows
        slots[:n] = free[:n]
        prompts = np.zeros((self.slots, self.prompt_len), np.int64)
        for row, (slot, r) in enumerate(zip(slots[:n], admitted)):
            self.active[slot] = r
            seq = r.prompt[-self.prompt_len:]
            prompts[row, -len(seq):] = seq
        rids = np.zeros((self.slots,), np.int32)
        rids[:n] = [r.rid for r in admitted]
        self.prefill_flops_proxy += self.prompt_len * self.slots
        tokens = torch.as_tensor(prompts, device=self.device)
        logits, self.cache = api.prefill_slot(
            self.cfg, self.params, {"tokens": tokens}, self.cache, slots,
            max_len=self.max_len)
        prefilled = self.prompt_len
        dev_rids = torch.as_tensor(rids, device=self.device)
        if self.greedy:
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
        else:
            # same (salt, position) scheme as decode_n; decode positions
            # start at prefilled + 1, so the streams never collide
            nxt = TF.sample(logits, self._sample_seed, dev_rids,
                            torch.full_like(dev_rids, prefilled))
        dst = torch.as_tensor(slots[:n], device=self.device)
        self.seq_lens[dst] = prefilled
        self.last_tokens[dst] = nxt[:n]
        self.sample_salt[dst] = dev_rids[:n]
        nxt = nxt.cpu().numpy()
        now = time.time()
        for row, r in enumerate(admitted):
            r.out_tokens.append(int(nxt[row]))
            r.t_first = now
            if len(r.out_tokens) >= r.max_new_tokens:
                r.done = True
                r.t_done = now
        return True

    def _budgets(self) -> np.ndarray:
        """Decode tokens still owed per slot.  Requests longer than the
        ``max_len`` envelope degrade like the reference: the KV write
        clamps to the last row while tokens keep flowing."""
        b = np.zeros((self.slots,), np.int32)
        for i, r in enumerate(self.active):
            if r is None or r.done:
                continue
            b[i] = max(0, r.max_new_tokens - len(r.out_tokens))
        return b

    def _decode_chunk(self, num_steps: int) -> None:
        """Advance every live slot up to ``num_steps`` tokens; host-side
        bookkeeping runs once on the returned chunk."""
        budgets = self._budgets()
        t0 = time.perf_counter()
        toks, self.cache, self.seq_lens, self.last_tokens = api.decode_n(
            self.cfg, self.params, self.cache, self.last_tokens,
            self.seq_lens, torch.as_tensor(budgets, device=self.device),
            num_steps=num_steps, greedy=self.greedy, seed=self._sample_seed,
            salt=self.sample_salt)
        toks = toks.cpu().numpy()                    # (num_steps, B) — syncs
        self._record_latency(time.perf_counter() - t0)
        self._steps += num_steps
        now = time.time()
        for i, r in enumerate(self.active):
            got = int(min(budgets[i], num_steps))
            if r is None or r.done or got == 0:
                continue
            r.out_tokens.extend(int(t) for t in toks[:got, i])
            if budgets[i] <= got:                    # budget met this chunk
                r.done = True
                r.t_done = now

    def _n_active(self) -> int:
        return sum(1 for r in self.active
                   if r is not None and not r.done)

    # -- fleet introspection (host-side, no device sync) ----------------------

    @property
    def n_active(self) -> int:
        """Requests currently occupying decode slots (not yet done)."""
        return self._n_active()

    @property
    def n_pending(self) -> int:
        """Requests submitted but not yet admitted to a slot."""
        return len(self.pending)

    @property
    def free_slots(self) -> int:
        """Slots currently available for admission."""
        return sum(1 for r in self.active if r is None or r.done)

    @property
    def depth(self) -> int:
        """Total requests this engine still owes work to."""
        return self.n_active + self.n_pending

    def tokens_owed(self) -> int:
        """Decode tokens still owed across active + pending requests."""
        owed = int(self._budgets().sum())
        owed += sum(r.max_new_tokens for r in self.pending)
        return owed

    def chunk_time_ema(self, default: float = 0.05) -> float:
        """Smoothed per-chunk latency (seconds)."""
        return default if self._chunk_ema is None else self._chunk_ema

    def _record_latency(self, lat: float) -> None:
        self.chunk_lat_s.append(lat)
        # bound the history of a long-lived engine (the EMA keeps the tail)
        if len(self.chunk_lat_s) > 4096:
            del self.chunk_lat_s[:2048]
        self._chunk_ema = (lat if self._chunk_ema is None
                           else 0.7 * self._chunk_ema + 0.3 * lat)

    def expected_ttft_s(self, default_chunk_s: float = 0.05, *,
                        chunk_time_s: Optional[float] = None) -> float:
        """Heuristic TTFT estimate for the NEXT request submitted here (the
        reference's router signal)."""
        per_chunk = (chunk_time_s if chunk_time_s is not None
                     else self.chunk_time_ema(default_chunk_s))
        if self.free_slots > 0 and not self.pending:
            return per_chunk
        width = max(1, self.slots) * max(1, self.spec.chunk)
        return per_chunk * (1.0 + self.tokens_owed() / width)

    # -- driving --------------------------------------------------------------

    def step_chunk(self) -> int:
        """Admit + advance ONE decode chunk (`spec.chunk` steps); returns the
        number of still-active requests."""
        self._admit()
        if self._n_active() == 0:
            return 0
        self._decode_chunk(self.spec.chunk)
        return self._n_active()

    def step(self) -> int:
        """One decode step over all slots (a chunk of one step, so the
        numerics match ``run`` at any chunk size); returns #active."""
        self._admit()
        if self._n_active() == 0:
            return 0
        self._decode_chunk(1)
        return self._n_active()

    def run(self, max_steps: int = 1000) -> Dict[str, float]:
        """Serve until the queue drains; returns latency/throughput stats."""
        self.chunk_lat_s = []
        self._steps = 0
        t0 = time.time()
        while self._steps < max_steps:
            self._admit()
            if self._n_active() == 0:
                if self.pending:
                    # the whole wave finished at admission (budgets of one
                    # token): admit the next one.  The reference breaks
                    # here and leaves the queue unserved (ROADMAP.md,
                    # queue 3).
                    continue
                break
            self._decode_chunk(self.spec.chunk)
        wall = time.time() - t0
        done = [r for r in self.queue if r.done]
        produced = sum(len(r.out_tokens) for r in done)
        ttfts = [r.t_first - r.t_submit for r in done
                 if r.t_first and r.t_done and r.t_done >= t0]
        return {
            "requests_done": len(done),
            "tokens": produced,
            "wall_s": wall,
            "tokens_per_s": produced / max(wall, 1e-9),
            "mean_ttft_s": float(np.mean(ttfts)) if ttfts else 0.0,
            "p50_ttft_s": _pct(ttfts, 50),
            "p95_ttft_s": _pct(ttfts, 95),
            "decode_steps": self._steps,
            "chunk": self.spec.chunk,
            "p50_chunk_s": _pct(self.chunk_lat_s, 50),
            "p95_chunk_s": _pct(self.chunk_lat_s, 95),
        }
