"""`repro_torch.fleet.traffic` against `repro.fleet.traffic`.

The port keeps its own copy of the traffic engine (numpy only).  The same
spec and seed must give the reference's columns, prompts, tiers and
deadlines bit for bit from every generator (`generate_trace`,
`generate_legacy`, `generate`, `uniform_burst`), and the port's copy keeps
the invariants `tests/test_traffic.py` pins on the reference's: the
vectorized trace equals the per-request loop, the columns are consistent,
the vectorized rate equals the scalar one.
"""
import dataclasses

import numpy as np
import pytest

from repro.fleet import traffic as JT
from repro_torch.fleet import TrafficSpec, generate, generate_trace
from repro_torch.fleet import traffic as TT
from repro_torch.fleet.traffic import generate_legacy

SPECS = {
    "poisson": dict(duration_s=20.0, rate_rps=8.0),
    "bursty": dict(duration_s=16.0, rate_rps=6.0, pattern="bursty",
                   burst_x=4.0, burst_period_s=4.0, burst_len_s=1.0),
    "diurnal": dict(duration_s=16.0, rate_rps=8.0, pattern="diurnal",
                    diurnal_period_s=8.0, trough_frac=0.25),
    "header_fewshot": dict(duration_s=10.0, rate_rps=10.0, header_len=6,
                           fewshot_len=8, fewshot_pool=3, fewshot_prob=0.5),
    # the fleet scenarios the port's chip smoke test serves
    "serve_fleet": dict(duration_s=4.0, rate_rps=4.0, pattern="bursty",
                        burst_x=10.0, burst_period_s=2.0, burst_len_s=0.5,
                        new_tokens_choices=(8, 16, 32),
                        new_tokens_weights=(0.5, 0.35, 0.15),
                        prompt_len_max=12, vocab_size=50304),
    "mixed_cluster": dict(duration_s=4.0, rate_rps=14.0, pattern="diurnal",
                          trough_frac=0.1, diurnal_period_s=4.0,
                          new_tokens_choices=(16, 32),
                          new_tokens_weights=(0.5, 0.5), prompt_len_max=8,
                          vocab_size=50304),
    "kv_prefix": dict(duration_s=2.0, rate_rps=8.0, header_len=224,
                      new_tokens_choices=(16, 32),
                      new_tokens_weights=(0.5, 0.5), vocab_size=50304),
}
PORT_SPECS = {k: TrafficSpec(**v) for k, v in SPECS.items()}
COLUMNS = ("t_arrival", "tier_idx", "ttft_slo_s", "new_tokens", "prompt_len",
           "prompt_off", "fewshot_idx", "tail_tokens")


def _assert_request_equal(a, b):
    assert a.fid == b.fid
    assert a.t_arrival == b.t_arrival        # bitwise float, no tolerance
    assert a.max_new_tokens == b.max_new_tokens
    assert a.tier == b.tier
    assert a.ttft_slo_s == b.ttft_slo_s
    assert a.prompt.dtype == b.prompt.dtype == np.int32
    assert np.array_equal(a.prompt, b.prompt)


# -- bitwise the reference's --------------------------------------------------

@pytest.mark.parametrize("name", sorted(SPECS))
@pytest.mark.parametrize("seed", [0, 2, 5, 17])
def test_trace_columns_bitwise_the_reference(name, seed):
    t = TT.generate_trace(PORT_SPECS[name], seed=seed)
    j = JT.generate_trace(JT.TrafficSpec(**SPECS[name]), seed=seed)
    assert len(t) == len(j) > 0
    for c in COLUMNS:
        a, b = getattr(t, c), getattr(j, c)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), c
    assert t.tokens_offered == j.tokens_offered
    for i in range(len(t)):
        _assert_request_equal(t.request(i), j.request(i))


@pytest.mark.parametrize("name", ["poisson", "header_fewshot", "serve_fleet"])
def test_legacy_and_generate_bitwise_the_reference(name):
    jspec = JT.TrafficSpec(**SPECS[name])
    for tgen, jgen in ((TT.generate_legacy, JT.generate_legacy),
                       (TT.generate, JT.generate)):
        got, want = tgen(PORT_SPECS[name], seed=3), jgen(jspec, seed=3)
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            _assert_request_equal(a, b)


def test_uniform_burst_and_rates_bitwise_the_reference():
    for kw in (dict(), dict(new_tokens=8, prompt_len=6, seed=4,
                            t_arrival=0.25, vocab_size=50304)):
        for a, b in zip(TT.uniform_burst(24, **kw),
                        JT.uniform_burst(24, **kw)):
            _assert_request_equal(a, b)
    for name, kw in SPECS.items():
        t, j = PORT_SPECS[name], JT.TrafficSpec(**kw)
        ts = np.linspace(0.0, t.duration_s, 57)
        assert t.rate_at(ts).tobytes() == j.rate_at(ts).tobytes()
        assert (t.rate_max, t.mean_new_tokens(),
                t.mean_offered_tokens_per_s()) == (
            j.rate_max, j.mean_new_tokens(), j.mean_offered_tokens_per_s())
    assert [dataclasses.astuple(x) for x in TT.DEFAULT_TIERS] == \
        [dataclasses.astuple(x) for x in JT.DEFAULT_TIERS]


# -- the reference's invariants on the port's copy ----------------------------

@pytest.mark.parametrize("name", ["poisson", "bursty", "diurnal",
                                  "header_fewshot"])
def test_trace_matches_legacy_bitwise(name):
    spec = PORT_SPECS[name]
    trace = generate_trace(spec, seed=17)
    legacy = generate_legacy(spec, seed=17)
    assert len(trace) == len(legacy) > 0
    for a, b in zip(trace.materialize(), legacy):
        _assert_request_equal(a, b)


def test_generate_is_materialized_trace():
    spec = PORT_SPECS["bursty"]
    for a, b in zip(generate(spec, seed=4),
                    generate_trace(spec, seed=4).materialize()):
        _assert_request_equal(a, b)


def test_lazy_request_matches_materialize():
    trace = generate_trace(PORT_SPECS["poisson"], seed=9)
    mat = trace.materialize()
    for i in (0, len(trace) // 2, len(trace) - 1):
        _assert_request_equal(trace.request(i), mat[i])


def test_sorted_and_consistent():
    spec = PORT_SPECS["diurnal"]
    trace = generate_trace(spec, seed=2)
    n = len(trace)
    assert np.all(np.diff(trace.t_arrival) >= 0)
    assert float(trace.t_arrival[-1]) < spec.duration_s
    off = np.zeros(n, dtype=np.int64)
    np.cumsum(trace.prompt_len[:-1], dtype=np.int64, out=off[1:])
    assert np.array_equal(trace.prompt_off, off)
    assert trace.tail_tokens.size == int(trace.prompt_len.sum())
    assert trace.tokens_offered == int(trace.new_tokens.sum())
    assert np.all((trace.tier_idx >= 0)
                  & (trace.tier_idx < len(spec.tiers)))


def test_prompt_slicing():
    trace = generate_trace(PORT_SPECS["poisson"], seed=6)
    i = len(trace) // 3
    p = trace.prompt(i)
    o = int(trace.prompt_off[i])
    assert np.array_equal(
        p[-int(trace.prompt_len[i]):],
        trace.tail_tokens[o:o + int(trace.prompt_len[i])])


@pytest.mark.parametrize("name", ["poisson", "bursty", "diurnal",
                                  "header_fewshot"])
def test_rate_at_array_matches_scalar(name):
    spec = PORT_SPECS[name]
    ts = np.linspace(0.0, spec.duration_s, 101)
    vec = spec.rate_at(ts)
    assert isinstance(vec, np.ndarray) and vec.dtype == np.float64
    scalars = np.array([spec.rate_at(float(t)) for t in ts])
    assert np.array_equal(vec, scalars)
    assert isinstance(spec.rate_at(0.0), float)
    assert float(np.max(vec)) <= spec.rate_max + 1e-12


def test_mean_offered_tokens_per_s():
    spec = TrafficSpec(duration_s=10.0, rate_rps=4.0)
    got = spec.mean_offered_tokens_per_s()
    assert got == pytest.approx(4.0 * spec.mean_new_tokens())


def test_thinning_tracks_diurnal_shape():
    spec = TrafficSpec(duration_s=400.0, rate_rps=8.0, pattern="diurnal",
                       diurnal_period_s=8.0, trough_frac=0.1)
    ts = generate_trace(spec, seed=1).t_arrival
    phase = ts % spec.diurnal_period_s
    near_peak = np.sum(np.abs(phase - 4.0) < 1.0)
    near_trough = np.sum((phase < 1.0) | (phase > 7.0))
    assert near_peak > 3 * near_trough
