"""The port's twins of the last four examples against the examples, on the
CPU: ``repro_torch.launch.topology_explorer``, ``fault_tolerant_training``,
``serve_lm`` and ``train_dlrm``.

  * topology_explorer: the twin's output equals the example's, character
    for character (both are host analytics over the same machine model);
  * fault_tolerant_training: the drill's report, one restart at step 4,
    and the machine's events equal to those the reference's
    ``repro.cluster.Supercomputer`` logs for the same two allocations and
    block failure (losses are held bitwise by
    ``tests/test_torch_cluster.py::test_fault_drill_matches_clean_run_bitwise``);
  * serve_lm: reduced olmo-1b on JAX's ``init_params(cfg, PRNGKey(0))``
    (the example's weights) through numpy on both sides, the twin's
    function against the example's flow through ``repro.cluster``; greedy
    streams token for token but at near ties (the JAX top-2 logit margin
    under LOGIT_REL_TOL of its largest |logit|: the position is reported);
    the CLI on every registered arch;
  * train_dlrm: the demo config equal to the example's; the first 5 losses
    on both routes from JAX's initial state (through numpy) within 1e-3 +
    2^-7 |loss| of the reference's session (the bar of
    ``tests/test_torch_train.py::test_loss_curve_matches_jax_train_step``);
    30 steps at batch 64 improve the loss; ``--scale full`` raises naming
    ROADMAP.md queue 1, item 12 before anything is allocated.

Every torch op of this file runs on one intra-op thread, and each
subprocess with OMP_NUM_THREADS=1, so the file leaves the other test
workers their cores.
"""
import dataclasses
import importlib.util
import os
import pathlib
import re
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.cluster import SliceSpec as JSpec
from repro.cluster import Supercomputer as JSupercomputer
from repro.models import api as JAPI
from repro.models import transformer as JTF
from repro_torch import interop
from repro_torch.configs import registry as TREG
from repro_torch.launch import fault_tolerant_training as TFT
from repro_torch.launch import serve_lm as TSL
from repro_torch.launch import topology_explorer as TTE
from repro_torch.launch import train_dlrm as TTD
from repro_torch.optim import adam as TOPT
from repro_torch.train.trainer import TrainerState

ROOT = pathlib.Path(__file__).resolve().parents[1]
LOGIT_REL_TOL = 2.0 ** -5
SUBPROCESS_TIMEOUT_S = 120


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The reduced models' ops are tiny: one intra-op thread runs them
    fastest, and leaves the other test workers their cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(name):
    """``examples/<name>.py`` as a module (the reference's flow)."""
    spec = importlib.util.spec_from_file_location(
        f"example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_module(*args):
    return subprocess.run(
        [sys.executable, "-m", *args], capture_output=True, text=True,
        timeout=SUBPROCESS_TIMEOUT_S, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                 OMP_NUM_THREADS="1"))


# -- topology_explorer ----------------------------------------------------------

@pytest.mark.parametrize("argv", [["--chips", "128", "--search"],
                                  ["--chips", "512"]],
                         ids=["128-search", "512"])
def test_topology_explorer_prints_the_example(argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["topology_explorer.py", *argv])
    _example("topology_explorer").main()
    want = capsys.readouterr().out
    TTE.main([*argv, "--device", "cpu"])
    got = capsys.readouterr().out
    assert got == want
    assert "goodput at this slice size" in got
    assert ("autotopo search" in got) == ("--search" in argv)


# -- fault_tolerant_training ----------------------------------------------------

def test_fault_tolerant_training_restores_and_matches(capsys):
    sc, sess, ref = TFT.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "matches clean run: True" in out
    assert "restarts:          1" in out and "steps run:         12" in out
    # the report is printed before the slices are freed
    assert [e.kind for e in sess.interruptions] == ["reconfigure", "free"]
    assert [e.kind for e in ref.interruptions] == ["free"]
    assert "\nsession interruptions:\n   reconfigure: block" in out
    assert [m["step"] for m in sess.metrics_log if m.get("event")] == [4]

    # the reference's machine: the same two allocations, the failure the
    # trainer injects (the faulted job's first block), the same two frees
    jsc = JSupercomputer()
    faulted, reference = jsc.allocate((8, 8, 8)), jsc.allocate((8, 8, 8))
    jsc.scheduler.fail_block(jsc.scheduler.jobs[faulted.job_id].blocks[0])
    printed = list(jsc.events)
    faulted.free()
    reference.free()
    assert [e.split()[0] for e in sc.events] == \
        [e.split()[0] for e in jsc.events] == \
        ["alloc", "alloc", "fail", "release", "release"]
    assert list(sc.events) == list(jsc.events)
    assert "\nmachine events:\n" + "".join(
        f"   {e}\n" for e in printed) + "\nsession interruptions:" in out


# -- serve_lm -------------------------------------------------------------------

def _jax_margin(cfg, jp, prompt, out_tokens, i, prompt_len):
    """JAX top-2 logit margin (and tolerance) where token ``i`` of a stream
    was chosen, teacher-forced over the engine's left-padded prompt."""
    pad = np.zeros((prompt_len,), np.int32)
    seq = np.asarray(prompt[-prompt_len:], np.int32)
    pad[-len(seq):] = seq
    ctx = np.concatenate([pad, np.asarray(out_tokens[:i], np.int32)])
    logits, _ = JTF.forward(cfg, jp, {"tokens": jnp.asarray(ctx)[None]})
    last = np.sort(np.asarray(logits[0, -1]))
    return float(last[-1] - last[-2]), LOGIT_REL_TOL * float(
        np.abs(last).max())


def test_serve_lm_streams_match_the_example_on_jax_weights(capsys):
    from repro.configs import registry as JREG
    ex = _example("serve_lm")
    jcfg = JREG.get_reduced("olmo-1b")
    np_params = jax.tree.map(np.asarray,
                             JAPI.init_params(jcfg, jax.random.PRNGKey(0)))
    jp = jax.tree.map(jnp.asarray, np_params)
    spec = TSL.example_spec()
    n = 8
    prompts = TSL.example_prompts(jcfg.vocab_size, n)

    # the example's flow: a (4, 4, 8) slice of the reference's machine
    with ex.Supercomputer().allocate((4, 4, 8)) as sl:
        jsess = sl.serve(jcfg, jp, JSpec(
            slots=spec.slots, max_len=spec.max_len,
            prompt_len=spec.prompt_len, chunk=spec.chunk))
        rng = np.random.default_rng(0)
        for i in range(n):
            prompt = rng.integers(0, jcfg.vocab_size,
                                  size=rng.integers(4, 12))
            np.testing.assert_array_equal(prompt, prompts[i])
            jsess.submit(prompt, max_new_tokens=16)
        jstats = jsess.run()
        want = [list(r.out_tokens) for r in jsess.engine.queue]

    stats, sess = TSL.serve_lm("olmo-1b", TREG.get_reduced("olmo-1b"),
                               interop.params_from_numpy(np_params), spec,
                               requests=n, new_tokens=16, device="cpu")
    out = capsys.readouterr().out
    got = [list(r.out_tokens) for r in sess.engine.queue]
    for k in ("requests_done", "tokens", "decode_steps", "chunk",
              "interruptions"):
        assert stats[k] == jstats[k], k
    assert stats["requests_done"] == n and stats["tokens"] == 16 * n
    assert set(stats) == set(jstats)
    assert out.startswith("arch=olmo-1b slice=4x4x8 slots=4\n")
    for k in jstats:
        assert f"\n  {k}: " in out
    for r, (w, g) in enumerate(zip(want, got)):
        assert len(g) == len(w) == 16
        diff = [i for i, (a, b) in enumerate(zip(w, g)) if a != b]
        if not diff:
            continue
        i = diff[0]
        margin, tol = _jax_margin(jcfg, jp, prompts[r], w, i,
                                  spec.prompt_len)
        assert margin < tol, (
            f"request {r}: token {i} differs (jax {w[i]}, port {g[i]}) "
            f"with a JAX top-2 margin {margin:.4f} >= tolerance {tol:.4f}")
        warnings.warn(f"request {r}: streams part at token {i}, a near tie "
                      f"(JAX top-2 margin {margin:.4f} < {tol:.4f})")


_TOKENS = re.compile(r"^  req(\d+): prompt=.*-> \[([0-9, ]*)\]\.\.\.$",
                     re.M)


@pytest.mark.parametrize("arch", TREG.ARCHS)
def test_serve_lm_cli_serves_every_arch(arch):
    res = _run_module("repro_torch.launch.serve_lm", "--device", "cpu",
                      "--arch", arch, "--requests", "2", "--slots", "2",
                      "--new-tokens", "4")
    cfg = TREG.get_reduced(arch)
    if cfg.family == "dlrm":
        # a scorer has no tokens to serve: refused before anything is made
        assert res.returncode == 2, res.stdout + res.stderr
        assert "not a language model" in res.stderr and not res.stdout
        return
    assert res.returncode == 0, res.stdout + res.stderr
    out = res.stdout
    assert out.startswith(f"arch={arch} slice=4x4x8 slots=2\n")
    assert "  requests_done: 2\n" in out and "  tokens: 8\n" in out
    assert f"  chunk: {1 if cfg.family == 'audio' else 8}\n" in out
    reqs = _TOKENS.findall(out)
    assert [int(r) for r, _ in reqs] == [0, 1]
    for _, toks in reqs:
        ids = [int(t) for t in toks.split(",")]
        assert len(ids) == 4 and all(0 <= t < cfg.vocab_size for t in ids)


# -- train_dlrm -----------------------------------------------------------------

def test_train_dlrm_demo_config_is_the_example(capsys):
    want = dataclasses.asdict(_example("train_dlrm").demo_config())
    assert dataclasses.asdict(TTD.demo_config()) == want


@pytest.mark.parametrize("pergroup", [False, True],
                         ids=["fused", "pergroup"])
def test_train_dlrm_first_losses_match_the_example(pergroup, tmp_path,
                                                   capsys):
    """5 steps of the example's run through the reference's cluster
    session and through the twin's, from the same initial state."""
    ex = _example("train_dlrm")
    from repro.configs.base import ParallelConfig as JPar
    from repro.configs.base import OptimizerConfig as JOpt
    from repro.configs.base import RunConfig as JRun
    from repro.configs.base import ShapeConfig as JShape
    steps, batch = 5, 256
    jrun = JRun(model=ex.demo_config(),
                shape=JShape("dlrm", "train", 1, batch),
                parallel=JPar(remat="none", emb_pipeline=not pergroup),
                optimizer=JOpt(lr=3e-4, warmup_steps=20))
    with ex.Supercomputer(num_blocks=8).allocate((4, 4, 4)) as sl:
        jsess = sl.train(jrun, ckpt_dir=str(tmp_path), ckpt_every=50)
        init = jsess.trainer.init_state()
        np_params = jax.tree.map(np.asarray, init.params)
        jsess.run(steps, log_every=1, state=init)
        want = [m["loss"] for m in jsess.metrics_log if "loss" in m]

    run = TTD.example_run(TTD.demo_config(), batch, pergroup)
    tp = interop.params_from_numpy(np_params)
    sess = TTD.train_dlrm(run, steps, "cpu", state=TrainerState(
        tp, TOPT.init(run.optimizer, tp), 0), log_every=1)
    got = [m["loss"] for m in sess.metrics_log if "loss" in m]
    assert [m["step"] for m in sess.metrics_log] == [1, 2, 3, 4, 5]
    assert len(got) == len(want) == steps
    for g, w in zip(got, want):
        assert abs(g - w) <= 1e-3 + 2.0 ** -7 * abs(w), (got, want)
    out = capsys.readouterr().out
    assert out.startswith("slice: 4x4x4\n") and "\nstep   bce-loss\n" in out


@pytest.mark.parametrize("pergroup", [False, True],
                         ids=["fused", "pergroup"])
def test_train_dlrm_cli_improves(pergroup, capsys):
    argv = ["--steps", "30", "--batch", "64", "--device", "cpu"]
    sess = TTD.main(argv + ["--pergroup"] * pergroup)
    out = capsys.readouterr().out
    assert sess.trainer.run.parallel.emb_pipeline is not pergroup
    assert re.search(r"\nloss \d+\.\d{4} -> \d+\.\d{4} \(improved\)\n$", out)
    assert sess.state.step == 30


def test_train_dlrm_full_scale_raises_before_allocating(monkeypatch):
    def allocate(*a, **k):
        raise AssertionError("--scale full allocated a machine")

    monkeypatch.setattr(TTD, "Supercomputer", allocate)
    monkeypatch.setattr(TTD, "train_dlrm", allocate)
    for device in ("cpu", "cuda"):
        with pytest.raises(NotImplementedError,
                           match=r"ROADMAP\.md queue 1, item 12"):
            TTD.main(["--scale", "full", "--device", device])
