"""Open-loop traffic generation: millions of users, one-machine-sized.

The fleet subsystem serves *offered* load — requests arrive on their own
clock whether or not the fleet keeps up (open-loop, the honest way to
measure serving systems; a closed loop would self-throttle and hide queueing
collapse).  `generate_trace` turns a `TrafficSpec` into a deterministic
structure-of-arrays `FleetTrace` (numpy columns: arrival time, tier,
prompt/output lengths, SLO deadline), and `generate` materializes it into
per-request `FleetRequest` objects for callers that want them:

  * **arrival process** — homogeneous Poisson ("poisson"), on/off modulated
    Poisson ("bursty": rate jumps `burst_x`-fold for `burst_len_s` every
    `burst_period_s`), or a smooth day-curve ("diurnal": sinusoid between
    trough and peak).  Non-constant rates are sampled by thinning, so every
    pattern is exact, not binned.
  * **mixed lengths** — prompt lengths are geometric-ish around a mean,
    output lengths drawn from a discrete mix (chat-short / completion-long),
    both clipped to the serving envelope.
  * **per-request SLOs** — each request carries a time-to-first-token
    deadline from its tier (interactive vs batch), so SLO attainment is a
    first-class fleet metric rather than an afterthought.

**Determinism layout.** Every column draws from its own counter-derived
PRNG substream (``default_rng([seed, column])``), and numpy fills arrays
element-by-element from the same bit stream a scalar loop would consume —
so the vectorized sampler and the retained per-request reference loop
(`generate_legacy`, the pre-vectorization generator kept as the
equivalence/speedup baseline) produce BITWISE-identical traces.  That pin
is what lets the fleet event loop trust `FleetTrace` at million-request
scale: same bits, ~100x+ cheaper.

All timestamps are *virtual seconds* on the fleet clock (see
`fleet.service`): replicas are independent slices of the machine, so their
compute overlaps in virtual time even though one device serializes it.

Port of ``repro/fleet/traffic.py``: a copy (numpy only, no torch), so a
spec and a seed give the reference's arrays and prompts bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np

# substream indices of the per-column generators (default_rng([seed, k]))
_S_GAP, _S_THIN, _S_PLEN, _S_TOKENS, _S_NEW, _S_TIER, _S_FSU, _S_FSI = \
    range(8)


def _col_rng(seed: int, column: int) -> np.random.Generator:
    """The PRNG substream of one trace column: independent of every other
    column, shared bit-for-bit between the scalar reference loop and the
    vectorized sampler (array fills consume the stream element-by-element,
    exactly like repeated scalar draws)."""
    return np.random.default_rng([seed, column])


@dataclasses.dataclass(frozen=True)
class SLOTier:
    """One traffic class: a share of requests and its TTFT deadline."""
    name: str
    ttft_slo_s: float
    share: float


DEFAULT_TIERS: Tuple[SLOTier, ...] = (
    SLOTier("interactive", ttft_slo_s=0.5, share=0.7),
    SLOTier("batch", ttft_slo_s=4.0, share=0.3),
)


@dataclasses.dataclass(eq=False)
class FleetRequest:
    """One user request, tracked end-to-end across replicas.

    ``eq=False`` for the same reason as `serve.engine.Request`: identity
    semantics — the router moves these between queues and a value-`__eq__`
    over ndarray prompts would break membership tests.

    The lifecycle fields are owned by the fleet: ``status`` walks
    pending -> queued -> done (or dropped), ``replicas`` records every
    replica that held the request (len > 1 means it survived a failure or
    drain migration), and ``out_tokens`` accumulates across migrations —
    tokens decoded on a replica that later died are re-prefilled as context
    on the survivor, never re-served to the user twice.
    """
    fid: int
    t_arrival: float                    # virtual seconds
    prompt: np.ndarray                  # (L,) int32
    max_new_tokens: int
    tier: str
    ttft_slo_s: float
    status: str = "pending"             # pending|queued|done|dropped
    replicas: List[int] = dataclasses.field(default_factory=list)
    migrations: int = 0
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    t_first: Optional[float] = None     # virtual first-token time
    t_done: Optional[float] = None      # virtual completion time

    @property
    def ttft_s(self) -> Optional[float]:
        return None if self.t_first is None else self.t_first - self.t_arrival

    @property
    def met_slo(self) -> bool:
        t = self.ttft_s
        return t is not None and t <= self.ttft_slo_s

    @property
    def remaining_tokens(self) -> int:
        return max(0, self.max_new_tokens - len(self.out_tokens))


@dataclasses.dataclass(frozen=True)
class TrafficSpec:
    """Knobs of one offered-load scenario."""
    duration_s: float = 8.0
    rate_rps: float = 4.0               # mean request rate (base rate)
    pattern: str = "poisson"            # poisson | bursty | diurnal
    # bursty: rate jumps to burst_x * rate_rps for burst_len_s every period
    burst_x: float = 4.0
    burst_period_s: float = 4.0
    burst_len_s: float = 1.0
    # diurnal: sinusoid between trough_frac*peak and peak, peak = rate_rps
    trough_frac: float = 0.25
    diurnal_period_s: float = 8.0
    # request shapes
    prompt_len_mean: float = 8.0
    prompt_len_max: int = 16
    new_tokens_choices: Tuple[int, ...] = (8, 16, 32)
    new_tokens_weights: Tuple[float, ...] = (0.5, 0.35, 0.15)
    tiers: Tuple[SLOTier, ...] = DEFAULT_TIERS
    vocab_size: int = 256
    # shared-header mix (prefix-shared KV traffic): every request's prompt
    # opens with its TIER's fixed system-prompt header of ``header_len``
    # tokens, optionally followed by one of ``fewshot_pool`` fixed few-shot
    # preambles (``fewshot_len`` tokens, attached with ``fewshot_prob``),
    # then the per-request random tail of the usual geometric length.
    # header_len=0 (default) leaves the trace BYTE-IDENTICAL to the
    # header-free generator — the extra RNG draws are gated, not skipped.
    header_len: int = 0
    fewshot_len: int = 0
    fewshot_pool: int = 0
    fewshot_prob: float = 0.0

    def __post_init__(self):
        assert self.pattern in ("poisson", "bursty", "diurnal"), self.pattern
        assert abs(sum(t.share for t in self.tiers) - 1.0) < 1e-6, self.tiers
        assert len(self.new_tokens_choices) == len(self.new_tokens_weights)
        assert self.header_len >= 0 and self.fewshot_len >= 0
        assert 0.0 <= self.fewshot_prob <= 1.0
        if self.fewshot_prob > 0:
            assert self.fewshot_len > 0 and self.fewshot_pool > 0, \
                "fewshot_prob needs fewshot_len and fewshot_pool"

    def tier_header(self, tier_idx: int) -> np.ndarray:
        """The fixed ``header_len``-token system-prompt header of tier
        ``tier_idx`` — deterministic in (tier, vocab, length) alone, so
        every trace/seed over this spec shares the same headers (that IS
        the sharing opportunity the kv pool exploits)."""
        rng = np.random.default_rng((tier_idx + 1) * 7919)
        return rng.integers(0, self.vocab_size, size=self.header_len,
                            dtype=np.int32)

    def fewshot_block(self, block_idx: int) -> np.ndarray:
        """Fixed few-shot preamble ``block_idx`` (same determinism contract
        as ``tier_header``)."""
        rng = np.random.default_rng(104729 + block_idx)
        return rng.integers(0, self.vocab_size, size=self.fewshot_len,
                            dtype=np.int32)

    def rate_at(self, t: Union[float, np.ndarray]
                ) -> Union[float, np.ndarray]:
        """Instantaneous arrival rate (requests/virtual-second) at time
        ``t`` — a scalar, or an ndarray of times evaluated in one shot (the
        vectorized thinning path and capacity planners both use this; a
        million timestamps cost one ufunc sweep, not a Python loop)."""
        ts = np.asarray(t, dtype=np.float64)
        if self.pattern == "poisson":
            out = np.broadcast_to(np.float64(self.rate_rps), ts.shape)
        elif self.pattern == "bursty":
            phase = ts % self.burst_period_s
            out = np.where(phase < self.burst_len_s,
                           self.rate_rps * self.burst_x, self.rate_rps)
        else:
            # diurnal: peak at period/2, trough at 0
            lo = self.rate_rps * self.trough_frac
            frac = 0.5 * (1.0 - np.cos(2 * np.pi * ts
                                       / self.diurnal_period_s))
            out = lo + (self.rate_rps - lo) * frac
        if np.ndim(t) == 0:
            return float(out)
        return np.asarray(out, dtype=np.float64)

    @property
    def rate_max(self) -> float:
        if self.pattern == "bursty":
            return self.rate_rps * self.burst_x
        return self.rate_rps

    def mean_offered_tokens_per_s(self) -> float:
        """Analytic mean decode-token demand (for capacity planning)."""
        mean_new = float(np.dot(self.new_tokens_choices,
                                self.new_tokens_weights))
        ts = np.linspace(0, self.duration_s, 257)
        mean_rate = float(np.mean(self.rate_at(ts)))
        return mean_rate * mean_new

    def mean_new_tokens(self) -> float:
        """Mean decode tokens per request under the output-length mix."""
        w = np.asarray(self.new_tokens_weights, dtype=np.float64)
        return float(np.dot(self.new_tokens_choices, w / w.sum()))


@dataclasses.dataclass
class FleetTrace:
    """One arrival trace as a structure of arrays — the fleet-scale form.

    A million requests are eight numpy columns plus one flat token buffer,
    not a million Python objects: the router and `FleetService` consume the
    columns directly (cursor indexing, vectorized capacity math) and only
    materialize a `FleetRequest` view at dispatch time, when a request
    actually enters an engine.  ``materialize``/``request`` reproduce the
    per-object generator's output bitwise (see `generate_legacy`).

    Columns (all length n, sorted by arrival):
      t_arrival    f8  virtual arrival seconds
      tier_idx     i4  index into ``spec.tiers``
      ttft_slo_s   f8  per-request TTFT deadline (tier lookup, denormalized)
      new_tokens   i4  decode tokens owed
      prompt_len   i4  RANDOM-TAIL prompt length (header/few-shot excluded)
      prompt_off   i8  offset of the tail in ``tail_tokens``
      fewshot_idx  i4  attached few-shot preamble, -1 = none
      tail_tokens  i4  flat buffer of every request's random prompt tail
    """
    spec: TrafficSpec
    seed: int
    t_arrival: np.ndarray
    tier_idx: np.ndarray
    ttft_slo_s: np.ndarray
    new_tokens: np.ndarray
    prompt_len: np.ndarray
    prompt_off: np.ndarray
    fewshot_idx: np.ndarray
    tail_tokens: np.ndarray

    def __len__(self) -> int:
        return int(self.t_arrival.shape[0])

    @property
    def tokens_offered(self) -> int:
        """Total decode tokens the trace demands (vectorized sum)."""
        return int(self.new_tokens.sum())

    def prompt(self, i: int) -> np.ndarray:
        """Materialize request ``i``'s full prompt (header + optional
        few-shot preamble + random tail), exactly as the per-object
        generator would have built it."""
        off = int(self.prompt_off[i])
        tail = self.tail_tokens[off:off + int(self.prompt_len[i])]
        if self.spec.header_len:
            parts = [self.spec.tier_header(int(self.tier_idx[i]))]
            if self.fewshot_idx[i] >= 0:
                parts.append(self.spec.fewshot_block(
                    int(self.fewshot_idx[i])))
            parts.append(tail)
            return np.concatenate(parts)
        return tail.copy()

    def request(self, i: int) -> FleetRequest:
        """Materialize the `FleetRequest` view of row ``i`` (dispatch-time
        only — the event loop never builds objects for requests that have
        not arrived yet)."""
        ti = int(self.tier_idx[i])
        return FleetRequest(
            fid=i, t_arrival=float(self.t_arrival[i]),
            prompt=self.prompt(i),
            max_new_tokens=int(self.new_tokens[i]),
            tier=self.spec.tiers[ti].name,
            ttft_slo_s=float(self.ttft_slo_s[i]))

    def materialize(self) -> List[FleetRequest]:
        """Every row as a `FleetRequest` (small traces / compat callers)."""
        return [self.request(i) for i in range(len(self))]


def _arrival_times(spec: TrafficSpec, seed: int) -> np.ndarray:
    """Candidate arrival instants of the dominating homogeneous Poisson
    process, vectorized but bit-identical to a scalar ``t += exp()`` loop:
    gaps come from the gap substream in blocks, and the running time is a
    strictly sequential cumsum (same float-add association as the loop)."""
    lam = spec.rate_max
    rng = _col_rng(seed, _S_GAP)
    expect = lam * spec.duration_s
    block = max(256, int(expect + 4.0 * np.sqrt(expect)) + 64)
    out: List[np.ndarray] = []
    t_end = 0.0
    while t_end < spec.duration_s:
        gaps = rng.exponential(1.0 / lam, size=block)
        # cumsum over [t_end, g0, g1, ...] reproduces ((t_end+g0)+g1)+...
        cum = np.cumsum(np.concatenate(([t_end], gaps)))[1:]
        t_end = float(cum[-1])
        out.append(cum)
    ts = np.concatenate(out)
    return ts[ts < spec.duration_s]


def generate_trace(spec: TrafficSpec, seed: int = 0) -> FleetTrace:
    """Sample one arrival trace as a `FleetTrace`: exact vectorized
    thinned-Poisson (non-homogeneous patterns thin against the peak rate,
    so every pattern is exact, not binned).

    Deterministic in (spec, seed), sorted by arrival, and bitwise-identical
    to `generate_legacy` on every column — the per-column substream layout
    makes array fills and scalar draws consume the same bits."""
    ts = _arrival_times(spec, seed)
    u = _col_rng(seed, _S_THIN).random(ts.size)
    keep = ~(u * spec.rate_max > spec.rate_at(ts))       # thinning, exact
    ts = ts[keep]
    n = int(ts.size)

    plen = np.clip(
        _col_rng(seed, _S_PLEN).geometric(1.0 / spec.prompt_len_mean,
                                          size=n),
        2, spec.prompt_len_max).astype(np.int32)
    off = np.zeros(n, dtype=np.int64)
    np.cumsum(plen[:-1], dtype=np.int64, out=off[1:])
    # tokens are uniform ids via floor(u * vocab): one double per token,
    # an order of magnitude cheaper than bounded-integer rejection at
    # fleet scale, and bit-reproducible between array and scalar draws
    tail = (_col_rng(seed, _S_TOKENS).random(int(plen.sum()))
            * spec.vocab_size).astype(np.int32)
    w = np.asarray(spec.new_tokens_weights) / sum(spec.new_tokens_weights)
    new = _col_rng(seed, _S_NEW).choice(
        np.asarray(spec.new_tokens_choices), size=n, p=w).astype(np.int32)
    shares = [t.share for t in spec.tiers]
    tier = _col_rng(seed, _S_TIER).choice(
        len(spec.tiers), size=n, p=shares).astype(np.int32)

    fewshot = np.full(n, -1, dtype=np.int32)
    if spec.header_len and spec.fewshot_pool:
        attach = _col_rng(seed, _S_FSU).random(n) < spec.fewshot_prob
        idx = _col_rng(seed, _S_FSI).integers(
            spec.fewshot_pool, size=int(attach.sum()))
        fewshot[attach] = idx.astype(np.int32)

    slo = np.asarray([t.ttft_slo_s for t in spec.tiers],
                     dtype=np.float64)[tier]
    return FleetTrace(spec=spec, seed=seed, t_arrival=ts, tier_idx=tier,
                      ttft_slo_s=slo, new_tokens=new, prompt_len=plen,
                      prompt_off=off, fewshot_idx=fewshot,
                      tail_tokens=tail)


def generate_legacy(spec: TrafficSpec, seed: int = 0) -> List[FleetRequest]:
    """The pre-vectorization generator: one Python `FleetRequest` per
    arrival, sampled request-by-request.  Kept as (a) the bitwise
    equivalence reference for `generate_trace` and (b) the baseline the
    `BENCH_predict.json` traffic-generation speedup gate measures against.
    Same substream layout, same bits, ~100x the cost at fleet scale."""
    lam_max = spec.rate_max
    rng_gap, rng_thin = _col_rng(seed, _S_GAP), _col_rng(seed, _S_THIN)
    rng_plen, rng_tok = _col_rng(seed, _S_PLEN), _col_rng(seed, _S_TOKENS)
    rng_new, rng_tier = _col_rng(seed, _S_NEW), _col_rng(seed, _S_TIER)
    rng_fsu, rng_fsi = _col_rng(seed, _S_FSU), _col_rng(seed, _S_FSI)
    headers = ([spec.tier_header(i) for i in range(len(spec.tiers))]
               if spec.header_len else [])
    fewshots = ([spec.fewshot_block(i) for i in range(spec.fewshot_pool)]
                if spec.header_len and spec.fewshot_pool else [])
    reqs: List[FleetRequest] = []
    t = 0.0
    while True:
        t += float(rng_gap.exponential(1.0 / lam_max))
        if t >= spec.duration_s:
            break
        if rng_thin.random() * lam_max > spec.rate_at(t):
            continue                        # thinned out
        plen = int(np.clip(rng_plen.geometric(1.0 / spec.prompt_len_mean),
                           2, spec.prompt_len_max))
        prompt = (rng_tok.random(plen) * spec.vocab_size).astype(np.int32)
        new = int(rng_new.choice(spec.new_tokens_choices,
                                 p=np.asarray(spec.new_tokens_weights)
                                 / sum(spec.new_tokens_weights)))
        tier_idx = int(rng_tier.choice(
            len(spec.tiers), p=[ti.share for ti in spec.tiers]))
        tier = spec.tiers[tier_idx]
        if spec.header_len:
            parts = [headers[tier_idx]]
            if spec.fewshot_pool and rng_fsu.random() < spec.fewshot_prob:
                parts.append(fewshots[int(rng_fsi.integers(len(fewshots)))])
            parts.append(prompt)
            prompt = np.concatenate(parts)
        reqs.append(FleetRequest(
            fid=len(reqs), t_arrival=t, prompt=prompt, max_new_tokens=new,
            tier=tier.name, ttft_slo_s=tier.ttft_slo_s))
    return reqs


def generate(spec: TrafficSpec, seed: int = 0) -> List[FleetRequest]:
    """Sample one arrival trace as `FleetRequest` objects (compat surface:
    the vectorized `generate_trace` materialized — identical bits, so
    object and trace callers of the same (spec, seed) see the same
    traffic).  Prefer `generate_trace` at fleet scale."""
    return generate_trace(spec, seed).materialize()


def uniform_burst(n: int, *, new_tokens: int = 16, prompt_len: int = 8,
                  ttft_slo_s: float = 10.0, vocab_size: int = 256,
                  seed: int = 0, t_arrival: float = 0.0
                  ) -> List[FleetRequest]:
    """N identical-shape requests arriving at once — the uniform closed
    batch used by the throughput-scaling gate and property tests."""
    rng = np.random.default_rng(seed)
    return [FleetRequest(
        fid=i, t_arrival=t_arrival,
        prompt=rng.integers(0, vocab_size, size=prompt_len, dtype=np.int32),
        max_new_tokens=new_tokens, tier="uniform", ttft_slo_s=ttft_slo_s)
        for i in range(n)]
