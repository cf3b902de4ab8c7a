#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py [--out results.json]

Needs one CUDA card (written for the H100, sm_90a) and ``nvcc``.  Phases,
each of which fails the run if it fails:

  1. build  — compile the port's CUDA kernels from ``src/repro_torch/
     kernels/csrc`` (``nvcc``, in parallel) and print ptxas's report;
  2. kernels — hold each kernel against its plain PyTorch version on the
     card, at the serving shapes (decode: B=8, H=KH=16, d=128, S=1024,
     ragged lengths with 0; prefill: B=8, H=16, T=128, d=128) and at small
     GQA / window / softcap / ragged-T shapes; time the kernel, the plain
     version and ``F.scaled_dot_product_attention`` (a yardstick only: the
     port never calls it) with CUDA events over inputs rotated past the
     50 MB L2; compute each kernel's bound from the bytes and flops these
     inputs need;
  3. reference — reduced olmo-1b with the same weights on the CPU (plain
     attention) and on the card (kernels): prefill and decode logits agree;
  4. serve — full-width olmo-1b (16 layers, d_model 2048, vocab 50304; bf16
     weights from a seeded generator) in ``ServeEngine(SliceSpec(slots=8,
     max_len=1024, prompt_len=128, chunk=8))``: 16 requests with ragged
     prompts of 32-128 tokens and 128 new tokens each (two admission
     waves).  Launch counters are zeroed just before ``run()`` and read
     just after: both kernels must have run on the main path.

Prints, last: a ``{"kernels": [...]}`` line, the card's name and power
limit as ``nvidia-smi`` gives them, and
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero without a CUDA device or without the repository's ``src``.
"""
import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor cores
# bf16 in and out, f32 inside both the kernel and its plain version: they
# differ by the last bf16 rounding (2^-8 relative) and f32 reordering.
KERNEL_ATOL = KERNEL_RTOL = 1e-2
# logits of the card (kernels, cuBLAS bf16) against the CPU (plain, CPU
# bf16 matmuls): 8 bf16 ulps at the largest logit, as the CPU tests use
LOGIT_REL_TOL = 2.0 ** -5


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def log(*a):
    print(*a, flush=True)


def cuda_ms(torch, fn, n_inputs, iters=30, warmup=3):
    """Mean ms per call of ``fn(i)`` by CUDA events; ``i`` rotates over
    ``n_inputs`` input sets so repeated calls do not run out of L2."""
    for i in range(warmup):
        fn(i % n_inputs)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fn(i % n_inputs)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(torch, got, want, what):
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    err = (got.float() - want.float()).abs()
    lim = KERNEL_ATOL + KERNEL_RTOL * want.float().abs()
    check(bool((err <= lim).all()),
          f"{what}: max |kernel - plain| {err.max().item():.3e} over "
          f"atol {KERNEL_ATOL} + rtol {KERNEL_RTOL}")
    return err.max().item()


def bound(nbytes, flops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / BF16_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_flops else (t_flops, "operations")


def decode_phase(torch, F, DA, REF):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    bf = torch.bfloat16

    def inputs(B, H, KH, S, d, lens):
        q = torch.randn((B, H, d), generator=gen, device=dev).to(bf)
        k = torch.randn((B, S, KH, d), generator=gen, device=dev).to(bf)
        v = torch.randn((B, S, KH, d), generator=gen, device=dev).to(bf)
        return q, k, v, torch.tensor(lens, dtype=torch.int32, device=dev)

    # small cases: GQA, MQA, window, softcap, lengths 0, 1 and S
    small = [((2, 8, 2, 300, 128, [0, 300]), dict(window=64, softcap=20.0)),
             ((3, 8, 1, 77, 64, [1, 77, 40]), dict(softcap=5.0)),
             ((3, 4, 4, 40, 16, [40, 0, 17]), dict(window=8, scale=0.3))]
    for (B, H, KH, S, d, lens), kw in small:
        a = inputs(B, H, KH, S, d, lens)
        max_err(torch, DA.paged_decode_attention(*a, **kw),
                REF.paged_decode_attention_ref(*a, **kw),
                f"decode B{B} H{H} KH{KH} S{S} d{d} {kw}")

    B, H, KH, S, d = 8, 16, 16, 1024, 128
    lens = [0, 1, 100, 257, 512, 700, 1000, 1024]
    sets = [inputs(B, H, KH, S, d, lens) for _ in range(3)]   # 3 x 67 MB
    err = max_err(torch, DA.paged_decode_attention(*sets[0]),
                  REF.paged_decode_attention_ref(*sets[0]),
                  "decode at serving shapes")
    ms = cuda_ms(torch, lambda i: DA.paged_decode_attention(*sets[i]), 3)
    plain_ms = cuda_ms(torch,
                       lambda i: REF.paged_decode_attention_ref(*sets[i]), 3)
    kpos = torch.arange(S, device=dev)
    masks = [(kpos[None, :] < s[3][:, None].long())[:, None, None, :]
             for s in sets]

    def library(i):
        q, k, v, _ = sets[i]
        return F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=masks[i])

    library_ms = cuda_ms(torch, library, 3)
    rows = sum(lens)
    nbytes = (2 * B * H * d * 2            # q in, out
              + 2 * rows * KH * d * 2      # the valid K and V rows
              + B * 4)                     # seq_lens
    flops = 4 * rows * H * d               # q.k and p.v
    bound_ms, bound_by = bound(nbytes, flops)
    return dict(name="paged_decode_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/decode_attention.cu",
                replaces="src/repro/kernels/decode_attention.py:112",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def prefill_phase(torch, F, FA, REF):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    bf = torch.bfloat16

    def inputs(B, H, KH, T, S, d):
        return (torch.randn((B, H, T, d), generator=gen, device=dev).to(bf),
                torch.randn((B, KH, S, d), generator=gen, device=dev).to(bf),
                torch.randn((B, KH, S, d), generator=gen, device=dev).to(bf))

    small = [((2, 8, 2, 77, 77, 128), dict(window=20, softcap=30.0)),
             ((1, 4, 1, 33, 33, 64), dict(causal=False)),
             ((2, 4, 2, 37, 37, 16), dict(window=5, softcap=4.0, scale=0.3))]
    for shape, kw in small:
        a = inputs(*shape)
        max_err(torch, FA.flash_attention(*a, **kw),
                REF.flash_attention_ref(*a, **kw), f"prefill {shape} {kw}")

    B, H, KH, T, d = 8, 16, 16, 128, 128
    sets = [inputs(B, H, KH, T, T, d) for _ in range(8)]      # 8 x 17 MB
    err = max_err(torch, FA.flash_attention(*sets[0]),
                  REF.flash_attention_ref(*sets[0]),
                  "prefill at serving shapes")
    ms = cuda_ms(torch, lambda i: FA.flash_attention(*sets[i]), 8)
    plain_ms = cuda_ms(torch, lambda i: REF.flash_attention_ref(*sets[i]), 8)
    library_ms = cuda_ms(
        torch, lambda i: F.scaled_dot_product_attention(*sets[i],
                                                        is_causal=True), 8)
    nbytes = 4 * B * H * T * d * 2                # q, k, v in; out
    flops = 4 * B * H * d * (T * (T + 1) // 2)    # causal q.k and p.v
    bound_ms, bound_by = bound(nbytes, flops)
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:86",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms)


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    return tree.to(device)


def reference_phase(torch, registry, api, TF, dev="cuda"):
    """Reduced olmo-1b, same weights: CPU (plain attention) vs card."""
    cfg = registry.get_reduced("olmo-1b")
    p_cpu = api.init_params(cfg, seed=0, device="cpu")
    p_gpu = _to(p_cpu, dev)
    toks = torch.randint(0, cfg.vocab_size, (3, 24),
                         generator=torch.Generator().manual_seed(0))
    worst = (0.0, 0.0, 0.0)                 # (err / tol, err, tol)
    outs = {}
    for name, p, d in (("cpu", p_cpu, "cpu"), ("gpu", p_gpu, dev)):
        logits, cache = api.prefill(cfg, p, {"tokens": toks.to(d)},
                                    max_len=40)
        lens = torch.tensor([24, 24, 24], dtype=torch.int32, device=d)
        active = torch.tensor([True, True, False], device=d)
        steps = [logits]
        for t in range(6):
            tk = toks[:, t].to(d)
            lg, cache, lens = TF.decode_step_paged(cfg, p, cache, tk, lens,
                                                   active)
            steps.append(lg[:2])
        outs[name] = [s.float().cpu() for s in steps]
    for i, (c, g) in enumerate(zip(outs["cpu"], outs["gpu"])):
        check(bool(torch.isfinite(g).all()), f"reference step {i}: not finite")
        tol = LOGIT_REL_TOL * c.abs().max().item()
        err = (c - g).abs().max().item()
        check(err <= tol, f"reference step {i}: card vs CPU logits differ by "
                          f"{err:.4f} > {tol:.4f}")
        worst = max(worst, (err / tol, err, tol))
    return worst


def serve_phase(torch, np, cfg, api, engine_mod, DA, FA, dev="cuda"):
    t0 = time.perf_counter()
    params = api.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    spec = engine_mod.SliceSpec(slots=8, max_len=1024, prompt_len=128,
                                chunk=8)
    rng = np.random.default_rng(0)
    # warm-up (cuBLAS handles, allocator), outside the counted run
    warm = engine_mod.ServeEngine(cfg, params, spec, device=dev)
    warm.submit(rng.integers(0, cfg.vocab_size, size=40), max_new_tokens=9)
    warm.run()
    del warm

    eng = engine_mod.ServeEngine(cfg, params, spec, device=dev)
    n_req, new_tokens = 16, 128
    reqs = [eng.submit(rng.integers(0, cfg.vocab_size,
                                    size=int(rng.integers(32, 129))),
                       max_new_tokens=new_tokens) for _ in range(n_req)]
    torch.cuda.reset_peak_memory_stats()
    DA.launches = FA.launches = 0
    stats = eng.run()
    launches = {"paged_decode_attention": DA.launches,
                "flash_attention": FA.launches}
    stats["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    stats["init_s"] = init_s
    stats["params"] = n_params
    check(stats["requests_done"] == n_req, f"served {stats['requests_done']}"
                                           f" of {n_req} requests")
    for r in reqs:
        check(r.done and len(r.out_tokens) == new_tokens,
              f"request {r.rid}: {len(r.out_tokens)} tokens of {new_tokens}")
        check(all(0 <= t < cfg.vocab_size for t in r.out_tokens),
              f"request {r.rid}: token id outside the vocabulary")
    waves = math.ceil(n_req / spec.slots)
    check(launches["paged_decode_attention"]
          >= cfg.num_layers * stats["decode_steps"],
          f"decode kernel launched {launches['paged_decode_attention']} times"
          f" for {stats['decode_steps']} steps x {cfg.num_layers} layers")
    check(launches["flash_attention"] >= cfg.num_layers * waves,
          f"prefill kernel launched {launches['flash_attention']} times for "
          f"{waves} waves x {cfg.num_layers} layers")
    # full-width logits are finite and of the expected shape
    toks = torch.as_tensor(np.stack([r.prompt[-64:] for r in reqs[:2]]),
                           device=dev).long()
    logits, _ = api.prefill(cfg, params, {"tokens": toks})
    check(tuple(logits.shape) == (2, cfg.vocab_size)
          and bool(torch.isfinite(logits).all()),
          f"full-width prefill logits {tuple(logits.shape)} not finite")
    stats["profile"] = profile_chunk(torch, np, cfg, params, engine_mod, spec)
    return stats, launches


def profile_chunk(torch, np, cfg, params, engine_mod, spec):
    """torch.profiler over one decode chunk of 8 full slots (after a warm
    chunk): device kernel time, launches and the top kernels.  Where the
    profiler records no device time this says so instead of a number."""
    from torch.profiler import ProfilerActivity, profile
    eng = engine_mod.ServeEngine(cfg, params, spec, device="cuda")
    rng = np.random.default_rng(1)
    for _ in range(spec.slots):
        eng.submit(rng.integers(0, cfg.vocab_size, size=spec.prompt_len),
                   max_new_tokens=4 * spec.chunk)
    eng.step_chunk()                        # admission + a warm chunk
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.step_chunk()                        # the same work, unprofiled
    torch.cuda.synchronize()
    wall_plain = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        eng.step_chunk()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    ms = [(e.name, e.time_range.elapsed_us() / 1e3) for e in dev_events]
    busy_ms = sum(t for _, t in ms)
    if not dev_events or busy_ms <= 0:
        return {"device_time": "not measured (no device events recorded)"}
    by_name = {}
    for name, t in ms:
        by_name[name] = by_name.get(name, 0.0) + t
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"steps": spec.chunk, "wall_ms": wall_plain * 1e3,
            "wall_ms_profiled": wall * 1e3, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / (wall_plain * 1e3)),
            "device_events": len(dev_events),
            "device_events_per_step": len(dev_events) / spec.chunk,
            "top_device_ms": [[n[:70], t] for n, t in top]}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    src = Path(__file__).resolve().parent / "src"
    if not (src / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.configs import registry
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ref as REF
    from repro_torch.models import api
    from repro_torch.models import transformer as TF
    from repro_torch.serve import engine as engine_mod

    # the plain versions compute f32 products: keep TF32 out of them
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip()
    check(smi.returncode == 0 and card, f"nvidia-smi failed: {smi.stderr}")
    log(f"card: {card}; torch {torch.__version__} cuda {torch.version.cuda}")

    t0 = time.perf_counter()
    build.build(verbose=True)
    build.library()
    log(f"build: {time.perf_counter() - t0:.1f} s")
    log(build.build_log.strip())

    decode = decode_phase(torch, F, DA, REF)
    log("decode kernel:", json.dumps(decode))
    prefill = prefill_phase(torch, F, FA, REF)
    log("prefill kernel:", json.dumps(prefill))
    worst = reference_phase(torch, registry, api, TF)
    log(f"reference: card vs CPU logits differ by at most {worst[1]:.3e} "
        f"(tolerance {worst[2]:.3e} at that step)")
    stats, launches = serve_phase(torch, np, registry.get_config("olmo-1b"),
                                  api, engine_mod, DA, FA)
    log("serve:", json.dumps(stats))

    decode["launches"] = launches["paged_decode_attention"]
    prefill["launches"] = launches["flash_attention"]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    kernels = {"kernels": [{k: kern[k] for k in keys}
                           for kern in (decode, prefill)]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            dict(card=card, serve=stats, reference_worst=worst,
                 build_s=build.build_seconds, **kernels), indent=2))
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
