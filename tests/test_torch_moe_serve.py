"""The port's MoE serving path on reduced qwen3-moe and kimi-k2 (a shared
expert and a dense prefix layer), against the JAX package.

Same weights on both sides (JAX's ``init_params``, handed over through
numpy), same prompts.  The JAX side runs as its own tests run it:
``api.prefill``, ``transformer.forward`` / ``decode_step_paged`` and the
JAX ``ServeEngine`` on the CPU.

Tolerance.  Logits and KV agree within LOGIT_TOL = 2**-5 * max|value| (8
bf16 ulps at the largest), as the dense slice's.  Routing adds one thing:
the router's logits are bf16, so two experts often tie or nearly tie, and
the ulp by which the two frameworks' hidden states differ can pick the
other expert.  The tests record every MoE call of both frameworks in
lockstep (the JAX package runs under ``jax.disable_jit()`` there, so its
calls are concrete) and compare, token by token, the experts chosen and
the experts kept after capacity.  A token that chose other experts
while nothing before it in its row had split in an earlier layer must
be a near tie in JAX's own logits (its k-th and (k+1)-th router logits
within ROUTE_TOL = 2**-5 * its max |logit|), else the test fails; a
token that chose the same experts but kept others lost a capacity slot
to such a choice.  Values are compared at every position before the
first split of its row in any layer (causal attention carries a change
only forward in a row); the test reports the near tie.  Greedy
streams match token for token, except from a position where JAX's top-2
logit margin is under LOGIT_TOL or after a routing near tie in that
request's row or lane; the test reports the first such position.
"""
import contextlib
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as JREG
from repro.models import api as JAPI
from repro.models import moe as JM
from repro.models import transformer as JTF
from repro.serve.engine import ServeEngine as JEngine
from repro.serve.engine import SliceSpec as JSpec
from repro_torch import interop
from repro_torch.configs import registry as TREG
from repro_torch.configs.base import ShapeConfig as TShape
from repro_torch.launch import serve as TSERVE
from repro_torch.models import api as TAPI
from repro_torch.models import moe as TM
from repro_torch.models import transformer as TTF
from repro_torch.serve.engine import ServeEngine as TEngine
from repro_torch.serve.engine import SliceSpec as TSpec

ARCHS = ("qwen3-moe-30b-a3b", "kimi-k2-1t-a32b")
LOGIT_REL_TOL = 2.0 ** -5
ROUTE_REL_TOL = 2.0 ** -5
SPEC = dict(slots=2, max_len=64, prompt_len=16, chunk=4)
# ragged prompts, 5 requests over 2 slots: several admission waves
PROMPT_LENS = (5, 16, 9, 12, 3)
BUDGETS = (12, 6, 10, 7, 9)
NEVER = 1 << 30


def _tol(x: np.ndarray) -> float:
    return LOGIT_REL_TOL * float(np.abs(x).max())


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    jcfg = JREG.get_reduced(request.param)
    p = jax.tree.map(np.asarray, JAPI.init_params(jcfg, jax.random.PRNGKey(0)))
    return dict(jcfg=jcfg, tcfg=TREG.get_reduced(request.param),
                jp=jax.tree.map(jnp.asarray, p),
                tp=interop.params_from_numpy(p))


@pytest.fixture(scope="module")
def prompts():
    rng = np.random.default_rng(0)
    return [rng.integers(0, 512, size=n).astype(np.int32)
            for n in PROMPT_LENS]


def _serve(engine, prompts, budgets=BUDGETS):
    reqs = [engine.submit(p, max_new_tokens=m)
            for p, m in zip(prompts, budgets)]
    stats = engine.run()
    assert stats["requests_done"] == len(prompts)
    return [list(r.out_tokens) for r in reqs]


@pytest.fixture(scope="module")
def jax_streams(model, prompts):
    return _serve(JEngine(model["jcfg"], model["jp"], JSpec(**SPEC)), prompts)


@pytest.fixture(scope="module")
def port_streams(model, prompts):
    return _serve(TEngine(model["tcfg"], model["tp"], TSpec(**SPEC),
                          device="cpu"), prompts)


# ---------------------------------------------------------------------------
# Routing records
# ---------------------------------------------------------------------------

def _kept(e: np.ndarray, capacity: int) -> np.ndarray:
    """The experts a token's pairs reach, in a numpy copy of the sorted
    dispatch: each expert keeps its first ``capacity`` pairs in the stable
    order of the flattened ids.  Rows sorted, a dropped pair as -1."""
    flat = e.reshape(-1)
    order = np.argsort(flat, kind="stable")
    srt = flat[order]
    pos = np.empty_like(flat)
    pos[order] = np.arange(flat.size) - np.searchsorted(srt, srt)
    return np.sort(np.where((pos < capacity).reshape(e.shape), e, -1), 1)


class Routes:
    """The MoE calls of both frameworks, in call order: each token's
    experts as chosen (top-1 first) and as kept after capacity, and on the
    JAX side the margin between its k-th and (k+1)-th router logits and
    that margin's bar."""

    def __init__(self):
        self.jax, self.port = [], []          # (experts, margin, bar)
        self.jkept, self.tkept = [], []

    def first_affected(self, rows: int, T: int, first=None) -> np.ndarray:
        """(rows,): per row of the calls' (rows, T) tokens, the first
        position touched by a split, or NEVER (``first`` carries the rows'
        state in from earlier calls).  A token splits where it chose or
        kept other experts.  Fails unless each token that CHOSE
        differently while untouched (no split at or before its position
        in its row in an earlier call: causal attention carries a change
        only forward in a row) is a near tie of JAX's (a kept set that
        differs alone lost a capacity slot to such a choice); warns of
        the first."""
        assert len(self.jax) == len(self.port) == len(self.jkept)
        first = np.full((rows,), NEVER) if first is None else first.copy()
        pos = np.arange(T)
        for c, ((je, margin, bar), (te, _, _)) in enumerate(
                zip(self.jax, self.port)):
            touched = (pos[None, :] >= first[:, None]).reshape(-1)
            chose = (np.sort(je, 1) != np.sort(te, 1)).any(1)
            fresh = np.nonzero(chose & ~touched)[0]
            for t in fresh:
                assert margin[t] < bar[t], (
                    f"router call {c}, token {t}: experts {je[t].tolist()} "
                    f"(JAX) vs {te[t].tolist()} (port) with a JAX margin "
                    f"{margin[t]:.4f} >= {bar[t]:.4f}")
            if fresh.size:
                t = int(fresh[0])
                warnings.warn(f"router call {c}: token {t} chose other "
                              f"experts at a near tie (JAX margin "
                              f"{margin[t]:.4f} < {bar[t]:.4f})")
            m = (chose | (self.jkept[c] != self.tkept[c]).any(1)).reshape(
                rows, T)
            first = np.minimum(first, np.where(m.any(1), m.argmax(1), NEVER))
        return first

    def top1_moved(self) -> int:
        return sum(int((je[:, 0] != te[:, 0]).sum())
                   for (je, _, _), (te, _, _) in zip(self.jax, self.port))


@contextlib.contextmanager
def _recording(monkeypatch):
    """Record the routing of both frameworks; the JAX package runs its
    scans op by op meanwhile (``jax.disable_jit``) so its calls are
    concrete."""
    rec = Routes()
    origs = (JM.router_topk, TM.router_topk, JM._dispatch_sorted,
             TM._dispatch_sorted)

    def topk(side, orig, cfg, p, x, dtype):
        g, e, a = orig(cfg, p, x, dtype)
        margin = bar = None
        if side is rec.jax:
            lg = np.asarray(jnp.einsum("sd,de->se", x,
                                       p["router"].astype(dtype))
                            .astype(jnp.float32))
            if cfg.moe.router_softcap:
                cap = cfg.moe.router_softcap
                lg = cap * np.tanh(lg / cap)
            srt = -np.sort(-lg, axis=1)
            k = cfg.moe.top_k
            margin = srt[:, k - 1] - srt[:, k]
            bar = ROUTE_REL_TOL * np.abs(lg).max(1)
        side.append((np.asarray(e), margin, bar))
        return g, e, a

    def dispatch(kept, orig, x, gates, eidx, num_experts, capacity):
        kept.append(_kept(np.asarray(eidx), capacity))
        return orig(x, gates, eidx, num_experts, capacity)

    with monkeypatch.context() as mp:
        mp.setattr(JM, "router_topk", lambda cfg, p, x, dtype=jnp.bfloat16:
                   topk(rec.jax, origs[0], cfg, p, x, dtype))
        mp.setattr(TM, "router_topk", lambda cfg, p, x, dtype=torch.bfloat16:
                   topk(rec.port, origs[1], cfg, p, x, dtype))
        mp.setattr(JM, "_dispatch_sorted",
                   lambda *a: dispatch(rec.jkept, origs[2], *a))
        mp.setattr(TM, "_dispatch_sorted",
                   lambda *a: dispatch(rec.tkept, origs[3], *a))
        with jax.disable_jit():
            yield rec


# ---------------------------------------------------------------------------
# Against JAX: model paths
# ---------------------------------------------------------------------------

def test_forward_logits_and_aux_match_jax(model, monkeypatch):
    B, T = 3, 16
    toks = np.random.default_rng(1).integers(0, 512, size=(B, T))
    with _recording(monkeypatch) as rec:
        jl, ja = JTF.forward(model["jcfg"], model["jp"],
                             {"tokens": jnp.asarray(toks, jnp.int32)})
        tl, ta = TAPI.forward(model["tcfg"], model["tp"],
                              {"tokens": torch.from_numpy(toks)})
    jl = np.asarray(jl)
    assert tl.dtype == torch.float32 and tuple(tl.shape) == jl.shape
    first = rec.first_affected(B, T)
    assert (first > 0).any(), "every row's first token chose other experts"
    for b in range(B):
        n = min(first[b], T)
        np.testing.assert_allclose(tl.numpy()[b, :n], jl[b, :n],
                                   atol=_tol(jl), rtol=0, err_msg=f"row {b}")
    # the Switch loss: a bf16 bar, plus E / S for each token whose top-1
    # expert moved (its one-hot leaves one expert for another)
    E = model["tcfg"].moe.num_experts
    bound = (LOGIT_REL_TOL * abs(float(ja))
             + E / (B * T) * rec.top1_moved())
    assert abs(float(ta) - float(ja)) <= bound


def test_prefill_last_logits_and_kv_match_jax(model, monkeypatch):
    B, T, S = 6, 16, 48
    toks = np.random.default_rng(1).integers(0, 512, size=(B, T))
    with _recording(monkeypatch) as rec:
        jl, jc = JAPI.prefill(model["jcfg"], model["jp"],
                              {"tokens": jnp.asarray(toks, jnp.int32)},
                              max_len=S)
        tl, tc = TAPI.prefill(model["tcfg"], model["tp"],
                              {"tokens": torch.from_numpy(toks)}, max_len=S)
    jl = np.asarray(jl)
    first = rec.first_affected(B, T)
    held = first == NEVER
    assert held.any(), "every row's last token moved by a near tie"
    np.testing.assert_allclose(tl.numpy()[held], jl[held], atol=_tol(jl),
                               rtol=0)
    n_scan = TTF.num_moe_layers(model["tcfg"])
    assert tuple(tc.k.shape) == (n_scan, B, S, 2, 16)
    assert int(tc.pos) == T and not tc.k[:, :, T:].any()
    for t, j in ((tc.k, jc.k), (tc.v, jc.v)):
        t, j = t.float().numpy(), np.asarray(j.astype(jnp.float32))
        for b in range(B):                 # each row up to its first move
            upto = min(first[b], T)
            np.testing.assert_allclose(t[:, b, :upto], j[:, b, :upto],
                                       atol=_tol(j), rtol=0)
    npre = model["tcfg"].moe.dense_layers
    if not npre:
        assert tc.prefix_k is None and jc.prefix_k is None
        return
    # the dense prefix runs before any router: its KV is held whole
    assert len(tc.prefix_k) == len(jc.prefix_k) == npre
    for t, j in zip(tc.prefix_k + tc.prefix_v, jc.prefix_k + jc.prefix_v):
        j = np.asarray(j.astype(jnp.float32))
        assert tuple(t.shape) == j.shape == (B, S, 2, 16)
        np.testing.assert_allclose(t.float().numpy(), j, atol=_tol(j),
                                   rtol=0)


def test_decode_steps_match_jax_teacher_forced(model, monkeypatch):
    """Per-slot lengths, a frozen slot (it still routes), random input
    tokens: every step's logits compared, each lane up to its first
    routing near tie.  Three lanes at capacity factor 2.0 get C = 4 >= 3
    pairs an expert, so no lane's drop depends on another's choice."""
    B, T = 3, 16
    assert TM.capacity_for(B, model["tcfg"].moe, 2.0) >= B
    rng = np.random.default_rng(2)
    toks = rng.integers(0, 512, size=(B, T))
    with _recording(monkeypatch) as rec:
        _, jc = JAPI.prefill(model["jcfg"], model["jp"],
                             {"tokens": jnp.asarray(toks, jnp.int32)},
                             max_len=32)
        _, tc = TAPI.prefill(model["tcfg"], model["tp"],
                             {"tokens": torch.from_numpy(toks)}, max_len=32)
    live = rec.first_affected(B, T) == NEVER
    lens = np.full((B,), T, np.int32)
    jlens, tlens = jnp.asarray(lens), torch.from_numpy(lens)
    active = np.array([True, True, False])
    for step in range(20):              # runs past S: writes clamp to S-1
        tk = rng.integers(0, 512, size=B)
        with _recording(monkeypatch) as rec:
            jl, jc, jlens = JTF.decode_step_paged(
                model["jcfg"], model["jp"], jc, jnp.asarray(tk, jnp.int32),
                jlens, jnp.asarray(active))
            tl, tc, tlens = TTF.decode_step_paged(
                model["tcfg"], model["tp"], tc, torch.from_numpy(tk), tlens,
                torch.from_numpy(active))
        live &= rec.first_affected(B, 1, np.where(live, NEVER, 0)) == NEVER
        jl = np.asarray(jl)
        held = active & live
        np.testing.assert_allclose(tl.numpy()[held], jl[held],
                                   atol=_tol(jl[active]), rtol=0,
                                   err_msg=f"step {step}")
        np.testing.assert_array_equal(tlens.numpy(), np.asarray(jlens))
    assert (active & live).any(), "every active lane moved by a near tie"


def _lockstep_excuses(model, prompts, monkeypatch):
    """The engines' schedule (SPEC, BUDGETS: admission waves padded to
    ``slots`` rows, then chunks of decode steps) replayed through both
    frameworks' api in lockstep, both fed JAX's greedy tokens, routing
    recorded.  Returns JAX's streams and, per request, the first token
    index from which a difference is excused: a JAX top-2 logit margin
    under LOGIT_TOL there, or a routing near tie in its row or lane
    before it."""
    jcfg, jp, tcfg, tp = model["jcfg"], model["jp"], model["tcfg"], model["tp"]
    S, P, chunk = SPEC["slots"], SPEC["prompt_len"], SPEC["chunk"]
    jc = JAPI.init_cache(jcfg, S, SPEC["max_len"])
    tc = TAPI.init_cache(tcfg, S, SPEC["max_len"], device="cpu")
    pending = list(range(len(prompts)))
    owner = [None] * S
    streams = [[] for _ in prompts]
    excused = [NEVER] * len(prompts)
    lens = np.zeros((S,), np.int32)
    last = np.zeros((S,), np.int32)
    touched = np.zeros((S,), bool)        # a slot's row or lane has split

    def free(slot):
        r = owner[slot]
        return r is None or len(streams[r]) >= BUDGETS[r]

    def emit(r, logits, moved):
        srt = np.sort(logits)
        if moved or srt[-1] - srt[-2] < _tol(logits):
            excused[r] = min(excused[r], len(streams[r]))
        streams[r].append(int(np.argmax(logits)))

    while True:
        slots = [i for i in range(S) if free(i)][:len(pending)]
        if slots:
            wave, pending = pending[:len(slots)], pending[len(slots):]
            rows = np.full((S,), S, np.int64)
            rows[:len(slots)] = slots
            toks = np.zeros((S, P), np.int32)
            for row, r in enumerate(wave):
                seq = prompts[r][-P:]
                toks[row, -len(seq):] = seq
                owner[slots[row]] = r
            with _recording(monkeypatch) as rec:
                jl, jc = JAPI.prefill_slot(jcfg, jp,
                                           {"tokens": jnp.asarray(toks)}, jc,
                                           jnp.asarray(rows, jnp.int32),
                                           max_len=SPEC["max_len"])
                TAPI.prefill_slot(tcfg, tp, {"tokens": torch.from_numpy(toks)},
                                  tc, rows, max_len=SPEC["max_len"])
            moved = rec.first_affected(S, P) < NEVER
            jl = np.asarray(jl)
            for row, r in enumerate(wave):
                touched[slots[row]] = moved[row]
                emit(r, jl[row], moved[row])
                lens[slots[row]] = P
                last[slots[row]] = streams[r][-1]
        if all(free(i) for i in range(S)):
            if pending:
                continue
            return streams, excused
        owed = np.array([0 if free(i) else BUDGETS[owner[i]]
                         - len(streams[owner[i]]) for i in range(S)])
        for step in range(chunk):
            active = step < owed
            with _recording(monkeypatch) as rec:
                jl, jc, jlens = JTF.decode_step_paged(
                    jcfg, jp, jc, jnp.asarray(last), jnp.asarray(lens),
                    jnp.asarray(active))
                TTF.decode_step_paged(tcfg, tp, tc, torch.from_numpy(last),
                                      torch.from_numpy(lens),
                                      torch.from_numpy(active))
            touched = rec.first_affected(
                S, 1, np.where(touched, 0, NEVER)) < NEVER
            jl = np.asarray(jl)
            for i in np.nonzero(active)[0]:
                emit(owner[i], jl[i], touched[i])
                last[i] = streams[owner[i]][-1]
            lens = np.asarray(jlens).copy()


def test_engine_greedy_streams_match_jax(model, prompts, jax_streams,
                                         port_streams, monkeypatch):
    diff = {r: next(i for i, (a, b) in enumerate(zip(js, ts)) if a != b)
            for r, (js, ts) in enumerate(zip(jax_streams, port_streams))
            if js != ts}
    for r, ts in enumerate(port_streams):
        assert len(ts) == len(jax_streams[r]) == BUDGETS[r]
    if not diff:
        return
    replay, excused = _lockstep_excuses(model, prompts, monkeypatch)
    assert replay == jax_streams, "the lockstep replay left JAX's schedule"
    for r, i in diff.items():
        assert i >= excused[r], (
            f"request {r}: token {i} differs (jax {jax_streams[r][i]}, port "
            f"{port_streams[r][i]}) with no near tie at or before it")
        warnings.warn(f"request {r}: streams part at token {i}, after a near "
                      f"tie at token {excused[r]}")


def test_lockstep_replay_follows_the_jax_engine(model, prompts, jax_streams,
                                                monkeypatch):
    """The replay that explains a parted stream reproduces the JAX
    engine's streams, so its near ties are the engine's."""
    replay, excused = _lockstep_excuses(model, prompts, monkeypatch)
    assert replay == jax_streams
    assert len(excused) == len(prompts)


# ---------------------------------------------------------------------------
# Port-internal pins
# ---------------------------------------------------------------------------

def _port_outputs(model, prompts, budgets=BUDGETS, **spec):
    eng = TEngine(model["tcfg"], model["tp"], TSpec(**{**SPEC, **spec}),
                  device="cpu")
    return _serve(eng, prompts, budgets)


@pytest.mark.parametrize("chunk", [1, 3, 8])
def test_greedy_chunk_invariant_bitwise_at_uniform_budgets(model, prompts,
                                                           chunk):
    """Uniform budgets admit every wave at the same decode step whatever
    the chunk, so a MoE model's streams are bitwise chunk-invariant."""
    budgets = (8,) * len(prompts)
    assert (_port_outputs(model, prompts, budgets, chunk=chunk)
            == _port_outputs(model, prompts, budgets, chunk=4))


def test_step_matches_run(model, prompts, port_streams):
    eng = TEngine(model["tcfg"], model["tp"], TSpec(**SPEC), device="cpu")
    reqs = [eng.submit(p, max_new_tokens=m)
            for p, m in zip(prompts, BUDGETS)]
    while any(not r.done for r in reqs):
        eng.step_chunk()
    assert [list(r.out_tokens) for r in reqs] == port_streams


def test_decode_n_equals_its_steps_bitwise(model):
    """``decode_n`` is ``decode_step_paged`` with on-device selection and
    done-masking: the same tokens, lengths and caches, bit for bit."""
    cfg, p = model["tcfg"], model["tp"]
    toks = torch.from_numpy(np.random.default_rng(3).integers(0, 512, (2, 8)))
    _, c1 = TAPI.prefill(cfg, p, {"tokens": toks}, max_len=24)
    _, c2 = TAPI.prefill(cfg, p, {"tokens": toks}, max_len=24)
    start = torch.tensor([3, 7], dtype=torch.int32)
    lens0 = torch.tensor([8, 8], dtype=torch.int32)
    budget = torch.tensor([5, 2], dtype=torch.int32)
    got, c1, lens, last = TAPI.decode_n(cfg, p, c1, start, lens0, budget,
                                        num_steps=6)
    t, lens2, want = start, lens0, []
    for s in range(6):
        active = s < budget
        lg, c2, lens2 = TTF.decode_step_paged(cfg, p, c2, t, lens2, active)
        t = torch.where(active, lg.argmax(-1).to(torch.int32), t)
        want.append(t)
    assert torch.equal(got, torch.stack(want)) and torch.equal(last, t)
    assert torch.equal(lens, lens2) and lens.tolist() == [13, 10]
    assert torch.equal(c1.k, c2.k) and torch.equal(c1.v, c2.v)
    for a, b in zip(c1.prefix_k or [], c2.prefix_k or []):
        assert torch.equal(a, b)


def test_admission_writes_the_prefix_kv_and_drops_padding_rows(model,
                                                                prompts):
    """One request in a 2-slot engine: its wave's padding row (slot index
    ``slots``) leaves slot 1 untouched in every cache, the dense prefix's
    included."""
    eng = TEngine(model["tcfg"], model["tp"], TSpec(**SPEC), device="cpu")
    eng.submit(prompts[0], max_new_tokens=3)
    eng._admit()
    assert eng.seq_lens.tolist() == [SPEC["prompt_len"], 0]
    caches = [eng.cache.k] + list(eng.cache.prefix_k or [])
    assert eng.cache.k[:, 0].any() and not eng.cache.k[:, 1].any()
    for c in caches[1:]:
        assert c[0].any() and not c[1].any()
    assert len(caches) == 1 + model["tcfg"].moe.dense_layers


def test_moe_refuses_the_pooled_kv_cache_and_make_batch(model, prompts):
    """As the reference: pooled prefix-shared KV is dense-transformer only,
    and the decoder families draw training batches from ``Dataset``."""
    cfg = model["tcfg"]
    with pytest.raises(NotImplementedError, match="dense-transformer only"):
        TEngine(cfg, model["tp"], TSpec(**SPEC, kv_block=16), device="cpu")
    with pytest.raises(NotImplementedError, match="dense-transformer only"):
        TAPI.init_kv_pool(cfg, 8, 16, device="cpu")
    with pytest.raises(NotImplementedError, match="dense-transformer only"):
        TAPI.prefill_suffix(cfg, model["tp"], None, None, None, None, None)
    with pytest.raises(NotImplementedError, match="item 5"):
        TAPI.make_batch(cfg, TShape("x", "train", 8, 2), device="cpu")
    with pytest.raises(NotImplementedError, match="dense-transformer only"):
        TAPI.decode_n(cfg, model["tp"], TAPI.init_cache(cfg, 1, 8,
                                                        device="cpu"),
                      [0], [0], [1], num_steps=1, tables=[[0]])


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_serves_reduced_moe_on_cpu(arch, capsys):
    stats = TSERVE.main(["--arch", arch, "--reduced", "--device", "cpu",
                         "--requests", "3", "--slots", "2",
                         "--new-tokens", "5"])
    assert stats["requests_done"] == 3 and stats["tokens"] == 15
    assert '"requests_done": 3' in capsys.readouterr().out
