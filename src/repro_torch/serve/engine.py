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

``SliceSpec(kv_block > 0)`` serves from the pooled prefix-shared KV cache
(``serve/kvpool.py``): each slot's cache rows are a block table over one
pool, an admission whose prompt starts with blocks another request already
prefilled maps them and prefills only the rest, left-aligned, in dispatches
of a fixed ``(slots, suffix_len)`` shape (``api.prefill_suffix``), and
decode runs ``api.decode_n(tables=)``.  ``kv_share=False`` keeps the layout
and never shares: its greedy tokens equal the sharing engine's, bit for
bit.  ``SliceSpec(quant="int8")`` stores the matmul and embedding weights
as int8 with f32 tile scales (``models/quant.quantize_params``), bitwise
what the dequantised tree gives.

The engine's counters (``prefill_flops_proxy``, the ``kv_*`` counts and the
``serve.chunk_s`` histogram) live in an ``obs.Telemetry`` registry under the
reference's names and labels; the attributes are views of it.  The whisper
legacy path and the non-dense families raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import api
from repro_torch.models import quant as Q
from repro_torch.models import transformer as TF
from repro_torch.obs import Telemetry
from repro_torch.serve.kvpool import KVPool


@dataclasses.dataclass(frozen=True)
class SliceSpec:
    """Serving-session shape: the envelope of one engine (the fields of
    ``repro.serve.engine.SliceSpec``).

    ``chunk`` is the decode tokens advanced per host sync (1 = per-token,
    same numerics).  ``kv_block > 0`` selects the pooled prefix-shared KV
    cache; ``kv_share=False`` keeps its layout but never matches or
    publishes a prefix (the bitwise baseline arm); ``kv_blocks`` sizes the
    pool (0 = twice the tables' capacity, so published prefixes outlive
    slot churn)."""
    slots: int = 4                  # decode batch width
    max_len: int = 256              # KV-cache length per slot
    prompt_len: int = 32            # padded prefill length
    greedy: bool = True
    chunk: int = 8                  # decode steps per host sync
    kv_block: int = 0               # pooled KV block size (0 = dense cache)
    kv_share: bool = True           # match/publish prompt prefixes
    kv_blocks: int = 0              # pool size (0 = 2 * slots * table width)
    suffix_len: int = 0             # suffix-prefill dispatch width
                                    # (0 = prompt_len)
    quant: str = "none"             # weight storage: "none" | "int8"
                                    # (the engine quantises at init)

    def __post_init__(self):
        assert self.slots >= 1 and 0 < self.prompt_len <= self.max_len, self
        assert self.chunk >= 1, self
        assert self.quant in ("none", "int8"), self
        if self.kv_block:
            assert self.max_len % self.kv_block == 0, \
                f"max_len {self.max_len} not a multiple of kv_block " \
                f"{self.kv_block}"
            assert self.suffix_len >= 0 and self.kv_blocks >= 0, self


@dataclasses.dataclass(eq=False)
class Request:
    """One serving request (identity equality, as in the reference)."""
    rid: int
    prompt: np.ndarray              # (prompt_len,) int32
    max_new_tokens: int
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # stamps from time.monotonic(): only compared with each other, so a
    # wall-clock step cannot make t_done < t_first < t_submit
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
      obs: the `Telemetry` whose registry holds the engine's counters (a
        private one by default).
      obs_labels: labels of those counters, so engines that share one
        `Telemetry` stay apart.
    """

    def __init__(self, cfg: ModelConfig, params,
                 spec: Optional[SliceSpec] = None, *, device="cuda",
                 obs: Optional[Telemetry] = None,
                 obs_labels: Optional[Dict[str, Any]] = None):
        spec = spec or SliceSpec()
        self.device = api.resolve_device(device)
        if cfg.family == "audio":
            raise NotImplementedError(
                "the whisper legacy full-batch path waits for ROADMAP.md "
                "queue 1, item 11")
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} waits for ROADMAP.md queue 1, item 11")
        embed = params["embed"]
        pdev = (embed.q if isinstance(embed, Q.QTensor) else embed).device
        if pdev.type != self.device.type:
            raise ValueError(f"params live on {pdev}, the engine on "
                             f"{self.device}")
        if spec.quant == "int8":
            params = Q.quantize_params(cfg, params)
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
        # the prefill-cost proxy (dispatch width x rows, summed over prefill
        # dispatches) and the prefix-sharing counters, in the registry under
        # the reference's names; the attributes are views (below)
        self.obs = obs if obs is not None else Telemetry()
        labels = dict(obs_labels or {})
        reg = self.obs.metrics
        self._c_prefill = reg.counter("serve.prefill_flops_proxy", **labels)
        self._c_kv_prompt = reg.counter("serve.kv_prompt_tokens", **labels)
        self._c_kv_shared = reg.counter("serve.kv_shared_tokens", **labels)
        self._c_mig_shared = reg.counter(
            "serve.kv_migrated_shared_blocks", **labels)
        self._c_mig_suffix = reg.counter(
            "serve.kv_migrated_suffix_blocks", **labels)
        self._h_chunk = reg.histogram("serve.chunk_s", **labels)
        self._pooled = spec.kv_block > 0
        if self._pooled:
            nb = spec.max_len // spec.kv_block
            self._nb = nb
            self._suffix_len = spec.suffix_len or spec.prompt_len
            self.kvpool = KVPool(
                num_blocks=spec.kv_blocks or 2 * spec.slots * nb,
                block_size=spec.kv_block, slots=spec.slots,
                blocks_per_slot=nb)
            # host mirror of the tables; the out-of-pool sentinel marks an
            # unadmitted slot (its lanes are masked by seq_lens 0)
            self._tables_np = np.full((spec.slots, nb),
                                      self.kvpool.num_blocks, np.int32)
            self._put_tables()

    # -- request lifecycle ----------------------------------------------------

    def submit(self, prompt: np.ndarray, max_new_tokens: int = 32) -> Request:
        """Enqueue one prompt; returns its `Request` handle.  The prompt is
        truncated to the last `spec.prompt_len` tokens at prefill."""
        r = Request(rid=self._next_rid, prompt=np.asarray(prompt, np.int32),
                    max_new_tokens=max_new_tokens, t_submit=time.monotonic())
        self._next_rid += 1
        self.queue.append(r)
        self.pending.append(r)
        return r

    def _admit(self) -> bool:
        """Fill empty slots from the queue with ONE prefill over a wave
        padded to ``slots`` rows; padding rows carry the out-of-range slot
        index ``slots`` and are dropped."""
        if self._pooled:
            return self._admit_pooled()
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
        self._c_prefill.inc(self.prompt_len * self.slots)
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
        now = time.monotonic()
        for row, r in enumerate(admitted):
            r.out_tokens.append(int(nxt[row]))
            r.t_first = now
            if len(r.out_tokens) >= r.max_new_tokens:
                r.done = True
                r.t_done = now
        return True

    def _put_tables(self) -> None:
        self.tables = torch.as_tensor(self._tables_np, device=self.device)

    def _admit_pooled(self) -> bool:
        """Pooled admission: map each admitted prompt's shared prefix onto
        pool blocks already prefilled (``kvpool.admit``) and prefill only
        the rest, in dispatches of one shape: row i is slot i, ``suffix_len``
        tokens wide.  A row whose last prompt token lies in a dispatch
        commits its next token, length and salt there; every other row of
        it is a masked no-op.  Prefixes are published after the dispatches,
        so two admissions of one wave never share blocks still being
        written."""
        if not self.pending:
            return False
        free = [i for i, a in enumerate(self.active)
                if a is None or a.done]
        n = min(len(self.pending), len(free))
        if n == 0:
            return False
        if self.cache is None:
            self.cache = api.init_kv_pool(
                self.cfg, self.kvpool.num_blocks, self.spec.kv_block,
                device=self.device)
        admitted = self.pending[:n]
        del self.pending[:n]
        bs = self.spec.kv_block
        rows = []                              # (slot, request, start, seq)
        for slot, r in zip(free[:n], admitted):
            self.active[slot] = r
            seq = np.asarray(r.prompt, np.int32)[-self.prompt_len:]
            table, matched = self.kvpool.admit(
                slot, seq, share=self.spec.kv_share)
            self._tables_np[slot] = table
            self._c_kv_prompt.inc(len(seq))
            self._c_kv_shared.inc(matched * bs)
            rows.append((slot, r, matched * bs, seq))
        self._put_tables()
        Tc = self._suffix_len
        nchunk = max(1, -(-max(len(seq) - start
                               for (_, _, start, seq) in rows) // Tc))
        nxt_keep = np.zeros((self.slots,), np.int32)
        rids = np.zeros((self.slots,), np.int32)
        plens = np.zeros((self.slots,), np.int32)
        for slot, r, _, seq in rows:
            rids[slot] = r.rid
            plens[slot] = len(seq)
        dev_rids = torch.as_tensor(rids, device=self.device)
        dev_plens = torch.as_tensor(plens, device=self.device)
        for c in range(nchunk):
            tok = np.zeros((self.slots, Tc), np.int32)
            st = np.zeros((self.slots,), np.int32)
            vd = np.zeros((self.slots,), np.int32)
            commit = np.zeros((self.slots,), bool)
            for slot, r, start, seq in rows:
                s0 = start + c * Tc
                v = max(0, min(Tc, len(seq) - s0))
                st[slot] = min(s0, len(seq))
                vd[slot] = v
                if v:
                    tok[slot, :v] = seq[s0:s0 + v]
                    commit[slot] = s0 + v == len(seq)
            self._c_prefill.inc(Tc * self.slots)
            logits, self.cache = api.prefill_suffix(
                self.cfg, self.params, self.cache,
                torch.as_tensor(tok, device=self.device), st, vd,
                self.tables)
            if self.greedy:
                nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            else:
                # the dense path's (salt, position) scheme at the TRUE
                # prompt length (pooled rows are left-aligned, not padded)
                nxt = TF.sample(logits, self._sample_seed, dev_rids,
                                dev_plens)
            on = torch.as_tensor(commit, device=self.device)
            self.seq_lens = torch.where(on, dev_plens, self.seq_lens)
            self.last_tokens = torch.where(on, nxt, self.last_tokens)
            self.sample_salt = torch.where(on, dev_rids, self.sample_salt)
            if commit.any():
                nxt_keep[commit] = nxt.cpu().numpy()[commit]
        now = time.monotonic()
        for slot, r, _, _ in rows:
            r.out_tokens.append(int(nxt_keep[slot]))
            r.t_first = now
            if len(r.out_tokens) >= r.max_new_tokens:
                r.done = True
                r.t_done = now
            if self.spec.kv_share:
                self.kvpool.publish(slot)
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
            salt=self.sample_salt,
            tables=self.tables if self._pooled else None)
        toks = toks.cpu().numpy()                    # (num_steps, B) — syncs
        self._record_latency(time.perf_counter() - t0)
        self._steps += num_steps
        now = time.monotonic()
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

    # -- telemetry views: the counters as attributes -------------------------

    @property
    def prefill_flops_proxy(self) -> int:
        return self._c_prefill.value

    @property
    def kv_prompt_tokens(self) -> int:
        return self._c_kv_prompt.value

    @property
    def kv_shared_tokens(self) -> int:
        return self._c_kv_shared.value

    @property
    def kv_migrated_shared_blocks(self) -> int:
        return self._c_mig_shared.value

    @property
    def kv_migrated_suffix_blocks(self) -> int:
        return self._c_mig_suffix.value

    def _record_latency(self, lat: float) -> None:
        self.chunk_lat_s.append(lat)
        self._h_chunk.observe(lat)
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

    # -- migration and pooled-KV introspection --------------------------------

    def export_inflight(self) -> List[Request]:
        """Remove and return every request still owed tokens (admitted and
        pending), clearing their slots; they leave `queue` too.  A survivor
        re-prefills ``prompt + out_tokens`` and serves the remainder.

        A pooled engine also releases every slot's block table and counts
        the migration split: only an in-flight request's private blocks
        would move with it (``kv_migrated_suffix_blocks``); its shared
        prefix blocks stay in this pool's trie
        (``kv_migrated_shared_blocks``)."""
        moved: List[Request] = []
        for i, r in enumerate(self.active):
            if self._pooled and self.kvpool.table(i) is not None:
                if r is not None and not r.done:
                    shared = self.kvpool.shared_blocks(i)
                    self._c_mig_shared.inc(shared)
                    self._c_mig_suffix.inc(self._nb - shared)
                self.kvpool.release(i)
                self._tables_np[i] = self.kvpool.num_blocks
            if r is not None and not r.done:
                moved.append(r)
            self.active[i] = None
        if self._pooled:
            self._put_tables()
        moved.extend(self.pending)
        self.pending = []
        for r in moved:
            if r in self.queue:
                self.queue.remove(r)
        return moved

    def prefix_lookup(self, prompt: np.ndarray) -> int:
        """Shareable prefix tokens this engine's trie holds for ``prompt``
        now (0 when not pooled).  A peek: no reference taken, no LRU touch,
        so a router can score every replica."""
        if not self._pooled:
            return 0
        seq = np.asarray(prompt, np.int32)[-self.prompt_len:]
        return self.kvpool.match_len(seq) * self.spec.kv_block

    def weight_stream_bytes(self) -> int:
        """Storage bytes of the engine's params, the reference's measure of
        a decode step's weight stream.  The port dequantises a `QTensor` at
        each use (``quant.cast``), so its int8 decode step moves more bytes
        than this, not fewer."""
        return Q.storage_bytes(self.params)

    def kv_stats(self) -> Dict[str, int]:
        """The sharing and migration counters, and the pool's accounting
        when pooled.  ``prefill_flops_proxy`` is counted on the dense path
        too, so a dense arm and a pooled one compare on one meter."""
        s = self.kvpool.stats() if self._pooled else {}
        s.update(
            prefill_flops_proxy=self.prefill_flops_proxy,
            kv_prompt_tokens=self.kv_prompt_tokens,
            kv_shared_tokens=self.kv_shared_tokens,
            kv_migrated_shared_blocks=self.kv_migrated_shared_blocks,
            kv_migrated_suffix_blocks=self.kv_migrated_suffix_blocks,
        )
        return s

    def kv_close(self) -> None:
        """Release every slot table and the prefix trie, then audit the
        pool: asserts that every block is back on the free list."""
        if not self._pooled:
            return
        self.kvpool.close()
        self._tables_np[:] = self.kvpool.num_blocks
        self._put_tables()

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
        t0 = time.monotonic()
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
        wall = time.monotonic() - t0
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
