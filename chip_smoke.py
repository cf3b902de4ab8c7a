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
     50 MB L2, the card held for 20 ms or more first so the host queues
     the timed calls (the time is the card's, not the host's launch pace;
     the single-table lookup's 150 calls a batch log the host's ms beside
     it), kernel
     and SDPA in alternating turns (kernel, SDPA, SDPA, kernel); compute
     each kernel's bound from the bytes and flops these inputs need; then
     the pooled and int8 decode kernels at the serving
     decode shape (`pooled_kernel_phase`: a pool of 1024 blocks of 16
     rows, permuted tables with 4 shared blocks, ``quantize_kv`` of the
     same K/V; the int8 rows through ``ops`` once, counted), each against
     its plain version and the pooled ones bitwise the per-slot kernels on
     the gathered view; timed beside their plain versions and byte
     bounds, with SDPA on the gathered bf16 view (the gather apart) as a
     yardstick, in turns with the three kernels;
  3. reference — reduced olmo-1b with the same weights on the CPU (plain
     attention) and on the card (kernels): prefill and decode logits agree;
  4. serve — full-width olmo-1b (16 layers, d_model 2048, vocab 50304; bf16
     weights from a seeded generator) in ``ServeEngine(SliceSpec(slots=8,
     max_len=1024, prompt_len=128, chunk=8))``: 16 requests with ragged
     prompts of 32-128 tokens and 128 new tokens each (two admission
     waves).  Launch counters are zeroed just before ``run()`` and read
     just after: both kernels must have run on the main path.  Its memory
     is freed before the DLRM phases.
 4b. pooled decode — full-width olmo-1b over a pooled cache (1024 blocks
     of 16 rows, 8 slots of 64 blocks; prompts of 64-128 tokens from
     ``api.prefill_slot`` copied in; slots 0 and 1 share 4 blocks; slot 7
     unadmitted): 16 greedy steps of ``decode_step_paged(tables=)`` (the
     pooled kernel, counted), the same loop on the view gathered once, and
     ``api.decode_n(tables=)``: logits bitwise equal on the admitted
     slots, equal tokens, equal pools, no other pool row touched;
 4c. pooled engine — full-width olmo-1b in three ``ServeEngine``s on one
     shared-header trace (24 requests: one of 2 tiers' 224-token header,
     on half of them one of 2 16-token few-shot preambles, a tail of 8-32
     tokens within ``prompt_len``; 32 new tokens each): pooled with
     sharing (``benchmarks/kv_prefix.py``'s ``SliceSpec(slots=8,
     max_len=288, prompt_len=256, chunk=8, kv_block=16, suffix_len=64)``),
     pooled with ``kv_share=False`` and the dense spec of the same
     envelope, each counted on its own.  Share and no-share streams
     bitwise equal, ``kv_close`` finds every block back, sharing cuts
     ``prefill_flops_proxy`` and shares tokens, the pooled runs launch
     row 1 and never the flash kernel.  Reports tokens/s, TTFT, ms a
     decode chunk, ms a prefill dispatch (a suffix dispatch and a dense
     admission by CUDA events), a profile of one suffix dispatch, peak
     memory;
 4d. int8 weights — the serve phase's 16 requests in
     ``ServeEngine(SliceSpec(..., quant="int8"))``, counted (rows 1 and 2
     launched), then an engine on ``dequantize_params`` of the same
     quantised tree: streams bitwise equal.  Reports weight storage bytes
     against the bf16 tree's (0.5156), tokens/s and TTFT of both, and a
     profile of one decode chunk of each (the device time that
     dequantising every weight at its use adds a step);
  5. DLRM reference — reduced dlrm0 with the same weights and batch on the
     CPU (plain versions) and on the card (kernels): the logits of both
     lookup routes agree;
  6. DLRM kernels — the fused lookup, the row gather and the single-table
     lookup against their plain versions on the card: small edge cases
     (all ids -1, a mean slot with count 0, repeated rows, valency 1 and
     128, every dim; the single-table lookup at the fig9 shape V=8192,
     D=64, B=64, Vl=16), the int8 fused lookup at every dlrm0 width and
     the scatter of deduplicated ids (unique sorted ids with a -1 tail, a
     sorted stream with adjacent duplicates; bitwise), then the one-card
     dlrm0 (its 150 tables at published widths and valencies,
     vocabularies cut to 12e9 parameters = 48.0 GB f32, initialised on
     the card from seed 0 once) at B = 256 (the repo's per-chip batch:
     65,536 over 256 chips) and B = 4096 (a scoring batch for one card);
     the single-table lookup runs through ``ops.embedding_lookup``, one
     launch a table (counted), and is also held against the per-table
     route's result; each kernel is timed beside its plain version, its
     byte bound (each distinct row of the batch read once) and
     ``F.embedding_bag`` / ``F.embedding`` (yardsticks only: the port
     never calls them);
  7. DLRM scoring — ``api.forward`` on batches of B = 4096 from the port's
     ``make_batch``: 20 through the fused route, 3 through the per-table
     route, under ``torch.inference_mode()``.  Counters are zeroed just
     before and read just after: 1 fused launch a batch, 150 gathers a
     batch.  Reports samples/s, ms a batch, peak allocated memory (which
     shows that no padded copy of the 48 GB of tables was made) and the
     card's idle share over one batch.  Then the int8 fused lookup: the
     48 GB of tables quantised with ``quantize_row_space`` (12.0 GB int8
     + 0.76 GB of scales, peak < 66 GB checked), ``ops.fused_lookup_q``
     at B = 256 and 4096 (counted) against its plain version and, within
     the int8 rounding bound, the f32 fused lookup.  The tables are freed
     after.
  8. DLRM training reference — reduced dlrm0 with the same weights and
     batch on the CPU (plain versions) and on the card (kernels): one
     step's gradients agree through both lookup routes, the per-table one
     also with the fused one; then Adam on the same gradients agrees;
  9. fused-scatter kernel — the backward of the fused lookup against its
     plain version: small edge cases (a row named 10,000 times, invalid
     ids, every dim), then dlrm0 cut to 4e9 table parameters (16.0 GB f32)
     at B = 256 and B = 4096 from ``data/synthetic.Dataset``.  The kernel
     sums each row in (b, s) order, so it must equal, bit for bit, the
     plain version run with ``torch.use_deterministic_algorithms`` (whose
     ``index_add_`` sums duplicates in index order) and, on the small
     cases, the plain version on the CPU; two launches bitwise equal.  The
     whole call, the ordering alone, the kernel half alone (and its run
     and hot-run launches apart), the longest run alone and the zero fill
     alone are timed beside the plain version (default and deterministic),
     the byte bound and ``index_add_`` (one call a row space; a yardstick
     only); the batch's statistics (valid descriptors, distinct rows,
     longest run) come from the descriptors, not the key encoding.  At B = 4096, before the gradient is freed: each table's ids
     deduplicated (``dedup_ids``) and ``ops.embedding_scatter`` of its
     gradient rows (150 launches, counted) bitwise the table's slice of
     the gradient; timed whole, fill and kernel apart, beside the plain
     version and ``index_copy_``;
 10. training — ``Trainer.train`` on that dlrm0 at B = 4096 with
     ``OptimizerConfig(lr=3e-4, warmup_steps=20)``, as a user runs it:
     3 warm and 10 timed steps, each drawing its batch from
     ``Dataset.batch`` on the host (its calls timed apart), moving it to
     the card and stepping.  Counters are zeroed just before and read
     just after: one fused lookup and one fused scatter a step.  Then the
     same 13 batches, staged on the card first, through the train step
     alone (3 warm, 10 timed).  Reports ms a step and samples/s of both
     runs, the losses (all finite), that the params moved, the peak
     allocated memory of the user's run (< 72 GB: params, gradient, m and
     v of the tables are 64 GB), one step split into forward + backward
     and Adam, and the card's busy time by kernel and idle share over one
     profiled step of the user's loop and one on a batch on the card.
 11. per-table training — ``Trainer.train`` with
     ``ParallelConfig(emb_pipeline=False)`` on the same cut at B = 256, 2
     steps: one gather a table and one fused scatter a row space a step
     (counted), finite losses, params that move, peak < 72 GB.

Prints, last: a ``{"kernels": [...]}`` line, the card's name and power
limit as ``nvidia-smi`` gives them, and
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero without a CUDA device or without the repository's ``src``.
"""
import argparse
import contextlib
import gc
import hashlib
import json
import math
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12      # H100 SXM device memory
BF16_FLOPS_PER_S = 989e12      # H100 SXM dense bf16 tensor cores
F32_FLOPS_PER_S = 67e12        # H100 SXM f32 outside the tensor cores
# bf16 in and out, f32 inside both the kernel and its plain version: they
# differ by the last bf16 rounding (2^-8 relative) and f32 reordering.
KERNEL_ATOL = KERNEL_RTOL = 1e-2
# `cuda_ms` holds the card for at least this many clock cycles before the
# timed calls: ~20 ms at the H100's ~1.98 GHz; longer where the host
# takes longer to queue them, up to QUEUE_AHEAD_MAX_S
CARD_HZ = 1.98e9
QUEUE_AHEAD_CYCLES = 40_000_000
QUEUE_AHEAD_MAX_S = 0.5
# f32 in and out (embedding lookups): the kernel adds a slot's rows in
# column order, the plain version with torch.sum's tree; at most 128 rows
# of |x| <= ~5 differ by a few f32 ulps of the sum.  The gather is a copy.
EMB_ATOL = EMB_RTOL = 1e-5
DLRM_BATCH = 4096              # scoring batch on one card
DLRM_CHIP_BATCH = 65536 // 256   # the repo's per-chip dlrm0 batch
DLRM_TABLE_PARAMS = 12_000_000_000   # one-card cut: vocabularies only
# logits of the card (kernels, cuBLAS bf16) against the CPU (plain, CPU
# bf16 matmuls): 8 bf16 ulps at the largest logit, as the CPU tests use;
# the same bar holds each gradient leaf against its largest |g|
LOGIT_REL_TOL = 2.0 ** -5
TRAIN_TABLE_PARAMS = 4_000_000_000   # one-card training cut: 4 x 16.0 GB
TRAIN_BATCH = 4096
TRAIN_WARM, TRAIN_TIMED = 3, 10
TRAIN_PEAK_LIMIT = 72e9
# int8 copy of the 48 GB scoring tables (12.0 GB + 0.76 GB of scales)
# beside them, quantised 2^20 rows at a time
INT8_PEAK_LIMIT = 66e9
PER_TABLE_TRAIN_BATCH = DLRM_CHIP_BATCH
# Adam, card vs CPU on the same gradients: the same f32 operations, norms
# summed in other orders: 1e-6 of each element and of the leaf's largest
ADAM_RTOL = 1e-6


def check(cond, msg):
    if not cond:
        raise RuntimeError(msg)


def log(*a):
    print(*a, flush=True)


def cuda_ms(torch, fn, n_inputs, iters=30, warmup=3, host=None):
    """Mean ms per call of ``fn(i)`` on the card by CUDA events; ``i``
    rotates over ``n_inputs`` input sets so repeated calls do not run out
    of L2.  The card first spins while the host queues the timed calls:
    QUEUE_AHEAD_CYCLES, or twice the host's time to queue them (from the
    fastest warm-up call) where that is longer, up to QUEUE_AHEAD_MAX_S;
    so a call shorter than its host-side launch cost is timed by the
    card's work, not by the host's pace.  ``host``, a dict, gets the
    host's ms to queue one timed call (``host_ms``), the spin's ms at
    CARD_HZ (``queue_ahead_ms``) and whether the host took longer to
    queue the calls than the card spun (``host_bound``: then the card may
    have waited for the host)."""
    queue_s = []
    for i in range(warmup):
        t0 = time.perf_counter()
        fn(i % n_inputs)
        queue_s.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    cycles = max(QUEUE_AHEAD_CYCLES,
                 int(min(2 * min(queue_s) * iters, QUEUE_AHEAD_MAX_S)
                     * CARD_HZ))
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(cycles)
    start.record()
    t0 = time.perf_counter()
    for i in range(iters):
        fn(i % n_inputs)
    end.record()
    queued_s = time.perf_counter() - t0
    torch.cuda.synchronize()
    if host is not None:
        host.update(host_ms=queued_s * 1e3 / iters,
                    queue_ahead_ms=cycles / CARD_HZ * 1e3,
                    host_bound=queued_s > cycles / CARD_HZ)
    return start.elapsed_time(end) / iters


# a kernel and its library yardstick, timed in alternating turns: a card
# that drifts (clocks, power) moves both means alike
TURNS = ("kernel", "library", "library", "kernel")


def in_turns(torch, fns, n_inputs, order=TURNS):
    """`cuda_ms` of ``fns[name]`` once for each appearance of name in
    ``order``; returns ({name: mean ms}, {name: [ms of each turn]})."""
    got = {n: [] for n in fns}
    for n in order:
        got[n].append(cuda_ms(torch, fns[n], n_inputs))
    return {n: sum(v) / len(v) for n, v in got.items()}, got


def max_err(torch, got, want, what, atol=KERNEL_ATOL, rtol=KERNEL_RTOL):
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    check(got.shape == want.shape, f"{what}: shape {tuple(got.shape)} != "
                                   f"{tuple(want.shape)}")
    if not got.numel():
        return 0.0
    err = (got.float() - want.float()).abs()
    lim = atol + rtol * want.float().abs()
    check(bool((err <= lim).all()),
          f"{what}: max |kernel - plain| {err.max().item():.3e} over "
          f"atol {atol} + rtol {rtol}")
    return err.max().item()


def int8_half_sums(torch, scales, rows, slots, dmax):
    """(B, K, dmax): per slot, half the sum of the tile scales of its valid
    rows (divided by their count in a mean slot), lane by lane; what
    round-to-nearest int8 can move a slot's value.  Gathers scales only."""
    B = rows.shape[0]
    out = torch.zeros((B, slots.shape[0], dmax), device=rows.device)
    for k, (g, a, b, mean) in enumerate(slots.tolist()):
        sc = scales[g]
        ids = rows[:, a:b]
        valid = ids >= 0
        s = torch.where(valid[..., None], sc[ids.long().clamp_min(0)], 0.0)
        s = s.sum(dim=1) / 2                                    # (B, nt)
        if mean:
            s = s / valid.sum(dim=1, keepdim=True).clamp_min(1)
        lanes = s.repeat_interleave(128, dim=1)[:, :dmax]
        out[:, k, :lanes.shape[1]] = lanes
    return out


def check_int8_bound(torch, REF, got, f32, scales, rows, slots, what):
    """Fails unless the int8 lookup ``got`` is within the int8 rounding
    bound of the f32 lookup ``f32`` (lanes past a group's dim are zero in
    both), plus EMB_ATOL + EMB_RTOL |f32|; returns the largest share of
    the bound used."""
    torch.cuda.synchronize()
    # in place: at full width each (B, K, dmax) temporary is 0.63 GB
    lim = int8_half_sums(torch, scales, rows, slots, got.shape[2])
    lim.add_(f32.abs().mul_(EMB_RTOL)).add_(EMB_ATOL)
    err = got.sub(f32).abs_()
    check(bool((err <= lim).all()),
          f"{what}: int8 vs f32 lookup differ by {err.max().item():.3e}, "
          f"past half a scale a row")
    return err.div_(lim).max().item()


def bound(nbytes, flops, flops_per_s=BF16_FLOPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = flops / flops_per_s * 1e3
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

    mean, turns = in_turns(torch, {
        "kernel": lambda i: DA.paged_decode_attention(*sets[i]),
        "library": library}, 3)
    ms, library_ms = mean["kernel"], mean["library"]
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
                bound_by=bound_by, library_ms=library_ms, ms_turns=turns)


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
    plain_ms = cuda_ms(torch, lambda i: REF.flash_attention_ref(*sets[i]), 8)
    mean, turns = in_turns(torch, {
        "kernel": lambda i: FA.flash_attention(*sets[i]),
        "library": lambda i: F.scaled_dot_product_attention(*sets[i],
                                                            is_causal=True)},
        8)
    ms, library_ms = mean["kernel"], mean["library"]
    nbytes = 4 * B * H * T * d * 2                # q, k, v in; out
    flops = 4 * B * H * d * (T * (T + 1) // 2)    # causal q.k and p.v
    bound_ms, bound_by = bound(nbytes, flops)
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/kernels/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:86",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, ms_turns=turns)



# pooled block-table decode: the serving decode shape over a pool of
# POOL_BLOCKS blocks of POOL_BS rows, POOL_NB blocks a slot (1024 rows)
POOL_BS, POOL_NB, POOL_BLOCKS = 16, 64, 1024
POOL_STEPS = 16


def pooled_kernel_phase(torch, np, F, DA, REF, QU, ops, dev="cuda"):
    """Rows 3, 1q and 3q at the serving decode shape (B=8, H=KH=16, d=128,
    the decode phase's lengths): row 3 on a bf16 pool of 1024 blocks of 16
    rows with permuted tables (two slots share 4 blocks), rows 1q and 3q on
    ``quantize_kv`` of the same K/V (1q on the gathered int8 view).  Rows
    1q and 3q go once through ``ops`` (counted); each is held against its
    plain version, rows 3 and 3q bitwise against rows 1 and 1q on the
    gathered view, and timed beside its plain version and its byte bound.
    SDPA on the bf16 gathered view, with the gather timed apart, is logged
    as a yardstick: no single PyTorch call reads a block table or
    dequantises int8 KV (library_ms null)."""
    dev = torch.device(dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    bf = torch.bfloat16
    B, H, KH, d = 8, 16, 16, 128
    lens_l = [0, 1, 100, 257, 512, 700, 1000, 1024]
    lens = torch.tensor(lens_l, dtype=torch.int32, device=dev)

    def inputs(i):
        q = torch.randn((B, H, d), generator=gen, device=dev).to(bf)
        kv = [torch.randn((POOL_BLOCKS, POOL_BS, KH, d), generator=gen,
                          device=dev).to(bf) for _ in range(2)]
        # a permutation of the pool; slots 4 and 5 (512 and 700 rows)
        # share their first 4 blocks
        t = np.random.default_rng(i).permutation(POOL_BLOCKS)[:B * POOL_NB]
        t = t.reshape(B, POOL_NB).astype(np.int32)
        t[5, :4] = t[4, :4]
        t = torch.from_numpy(t).to(dev)
        (kq, ks), (vq, vs) = (QU.quantize_kv(x) for x in kv)
        view_q = [REF.pool_rows(x, t) for x in (kq, ks, vq, vs)]
        return dict(q=q, k=kv[0], v=kv[1], t=t, kq=kq, ks=ks, vq=vq, vs=vs,
                    view_q=view_q)

    # 6 sets (~0.35 GB each): their valid int8 rows alone are 6 x 15 MB,
    # past the 50 MB L2
    sets = [inputs(i) for i in range(6)]
    a = sets[0]
    # the counted run of rows 1q and 3q: through ops, as a caller
    DA.launches_q = DA.launches_bt_q = 0
    got_1q = ops.paged_decode_attention(
        a["q"], a["view_q"][0], a["view_q"][2], lens,
        k_scale=a["view_q"][1], v_scale=a["view_q"][3])
    got_3q = ops.paged_decode_attention_bt(
        a["q"], a["kq"], a["vq"], lens, a["t"], k_scale=a["ks"],
        v_scale=a["vs"])
    torch.cuda.synchronize()
    launches = {"paged_decode_attention_q8": DA.launches_q,
                "paged_decode_attention_bt_q8": DA.launches_bt_q}
    check(launches == {"paged_decode_attention_q8": 1,
                       "paged_decode_attention_bt_q8": 1},
          f"int8 decode through ops: launches {launches}")

    got_3 = DA.paged_decode_attention_bt(a["q"], a["k"], a["v"], lens,
                                         a["t"])
    err = {
        "bt": max_err(torch, got_3, REF.paged_decode_attention_bt_ref(
            a["q"], a["k"], a["v"], lens, a["t"]), "pooled decode"),
        "q8": max_err(torch, got_1q, REF.paged_decode_attention_ref(
            a["q"], a["view_q"][0], a["view_q"][2], lens,
            k_scale=a["view_q"][1], v_scale=a["view_q"][3]),
            "int8 decode"),
        "bt_q8": max_err(torch, got_3q, REF.paged_decode_attention_bt_ref(
            a["q"], a["kq"], a["vq"], lens, a["t"], k_scale=a["ks"],
            v_scale=a["vs"]), "pooled int8 decode")}
    check(torch.equal(got_3, DA.paged_decode_attention(
        a["q"], REF.pool_rows(a["k"], a["t"]), REF.pool_rows(a["v"], a["t"]),
        lens)),
        "pooled decode is not bitwise the per-slot kernel on the view")
    check(torch.equal(got_3q, DA.paged_decode_attention_q8(
        a["q"], *a["view_q"][:2], *a["view_q"][2:], lens)),
        "pooled int8 decode is not bitwise the per-slot int8 kernel on the "
        "view")

    def bt(i):
        x = sets[i]
        return DA.paged_decode_attention_bt(x["q"], x["k"], x["v"], lens,
                                            x["t"])

    def bt_plain(i):
        x = sets[i]
        return REF.paged_decode_attention_bt_ref(x["q"], x["k"], x["v"],
                                                 lens, x["t"])

    def q8(i):
        x = sets[i]
        return DA.paged_decode_attention_q8(x["q"], *x["view_q"], lens)

    def q8_plain(i):
        x = sets[i]
        kq, ks, vq, vs = x["view_q"]
        return REF.paged_decode_attention_ref(x["q"], kq, vq, lens,
                                              k_scale=ks, v_scale=vs)

    def bt_q8(i):
        x = sets[i]
        return DA.paged_decode_attention_bt_q8(
            x["q"], x["kq"], x["ks"], x["vq"], x["vs"], lens, x["t"])

    def bt_q8_plain(i):
        x = sets[i]
        return REF.paged_decode_attention_bt_ref(
            x["q"], x["kq"], x["vq"], lens, x["t"], k_scale=x["ks"],
            v_scale=x["vs"])

    # yardstick: SDPA on the bf16 view gathered beforehand (the gather
    # timed apart); in turns with the three kernels (3, 1q, 3q, SDPA, SDPA,
    # 3q, 1q, 3): ms is the mean of the two
    views = [(REF.pool_rows(x["k"], x["t"]), REF.pool_rows(x["v"], x["t"]))
             for x in sets]
    kpos = torch.arange(POOL_NB * POOL_BS, device=dev)
    mask = (kpos[None, :] < lens[:, None].long())[:, None, None, :]
    fns = {"bt": bt, "q8": q8, "bt_q8": bt_q8,
           "sdpa": lambda i: F.scaled_dot_product_attention(
               sets[i]["q"][:, :, None], views[i][0].transpose(1, 2),
               views[i][1].transpose(1, 2), attn_mask=mask)}
    ms, turns = in_turns(torch, fns, 6, ("bt", "q8", "bt_q8", "sdpa", "sdpa",
                                         "bt_q8", "q8", "bt"))
    plain_ms = {n: cuda_ms(torch, f, 6) for n, f in
                (("bt", bt_plain), ("q8", q8_plain), ("bt_q8", bt_q8_plain))}
    gather_ms = cuda_ms(torch, lambda i: (
        REF.pool_rows(sets[i]["k"], sets[i]["t"]),
        REF.pool_rows(sets[i]["v"], sets[i]["t"])), 6)
    sdpa_ms = ms["sdpa"]
    del views, fns

    rows = sum(lens_l)
    io = 2 * B * H * d * 2 + B * 4          # q in, out, seq_lens
    tables = B * POOL_NB * 4
    flops = 4 * rows * H * d                # q.k and p.v
    deq = 2 * rows * KH * d                 # int8: one multiply an element
    nbytes = {"bt": io + 2 * rows * KH * d * 2 + tables,
              "q8": io + 2 * rows * KH * (d + 4),
              "bt_q8": io + 2 * rows * KH * (d + 4) + tables}
    meta = {
        "bt": ("paged_decode_attention_bt",
               "src/repro/kernels/decode_attention.py:217", flops),
        "q8": ("paged_decode_attention_q8",
               "src/repro/kernels/decode_attention.py:100", flops + deq),
        "bt_q8": ("paged_decode_attention_bt_q8",
                  "src/repro/kernels/decode_attention.py:210", flops + deq)}
    out = {}
    for n, (name, replaces, ops_n) in meta.items():
        bound_ms, bound_by = bound(nbytes[n], ops_n)
        out[n] = dict(name=name, route="cuda",
                      source="src/repro_torch/kernels/csrc/decode_attention.cu",
                      replaces=replaces, max_abs_err=err[n], ms=ms[n],
                      plain_ms=plain_ms[n], bound_ms=bound_ms,
                      bound_by=bound_by, library_ms=None, bytes=nbytes[n],
                      ms_turns=turns[n], launches=launches.get(name))
    out["yardstick"] = {"gather_bf16_view_ms": gather_ms,
                        "sdpa_on_gathered_view_ms": sdpa_ms,
                        "sdpa_ms_turns": turns["sdpa"]}
    return out


def fill_pool(pool, dense, lens, tables):
    """Copy rows [0, lens[b]) of slot b of the per-slot cache ``dense``
    into the pool blocks ``tables[b]`` names, in place; a block an earlier
    slot filled (a shared prefix block) keeps that slot's rows."""
    filled = set()
    bs = pool.k.shape[2]
    for b, n in enumerate(lens):
        for j in range(-(-int(n) // bs)):
            blk = int(tables[b][j])
            if blk in filled:
                continue
            rows = min(bs, int(n) - j * bs)
            for dst, src in ((pool.k, dense.k), (pool.v, dense.v)):
                dst[:, blk, :rows] = src[:, b, j * bs:j * bs + rows]
            filled.add(blk)
    return filled


def pooled_decode_phase(torch, np, cfg, api, TF, DA, dev="cuda"):
    """Full-width olmo-1b over a pooled cache of 1024 blocks of 16 rows, 8
    slots of 64 blocks: prompts of 64-128 tokens prefilled by
    ``api.prefill_slot`` and copied into the pool (`fill_pool`), slots 0
    and 1 sharing their first 4 blocks, slot 7 unadmitted (table row the
    sentinel 1024, seq_len 0, budget 0).  16 greedy steps three ways:
    (A) ``decode_step_paged(tables=)`` (row 3, counted), (B) the same loop
    on the view gathered once (row 1), (C) ``api.decode_n(tables=)``.
    A's and B's logits are bitwise equal on the admitted slots, the tokens
    of all three are equal, A's pool is bitwise C's, and every pool row
    but the decoded ones is unchanged."""
    params = api.init_params(cfg, seed=0, device=dev)
    B, V = 8, cfg.vocab_size
    rng = np.random.default_rng(3)
    plens = [int(n) for n in rng.integers(64, 129, size=B - 1)] + [0]
    prompts = [rng.integers(0, V, size=n) for n in plens[:-1]]
    prompts[1][:4 * POOL_BS] = prompts[0][:4 * POOL_BS]
    dense = api.init_cache(cfg, B, 128, device=dev)
    feed = torch.zeros(B, dtype=torch.int32, device=dev)
    for b, p in enumerate(prompts):
        logits, dense = api.prefill_slot(
            cfg, params, {"tokens": torch.as_tensor(p, device=dev)[None]},
            dense, b, max_len=128)
        feed[b] = torch.argmax(logits[0])
    t = np.random.default_rng(4).permutation(POOL_BLOCKS)[:B * POOL_NB]
    t = t.reshape(B, POOL_NB).astype(np.int32)
    t[1, :4] = t[0, :4]
    t[7] = POOL_BLOCKS
    tables = torch.from_numpy(t).to(dev)
    start = api.init_kv_pool(cfg, POOL_BLOCKS, POOL_BS, device=dev)
    g = torch.Generator(device=dev).manual_seed(5)
    for x in (start.k, start.v):            # unused rows hold garbage
        x.normal_(generator=g)
    fill_pool(start, dense, plens, t)
    del dense
    lens0 = torch.tensor(plens, dtype=torch.int32, device=dev)
    budget = torch.tensor([POOL_STEPS] * (B - 1) + [0], dtype=torch.int32,
                          device=dev)

    def copy(c):
        return TF.Cache(k=c.k.clone(), v=c.v.clone(), pos=c.pos.clone())

    def loop(cache, tables_):
        """16 greedy steps of decode_step_paged; (tokens, logits, cache,
        ms a step by the host clock between two synchronisations)."""
        tk, ln = feed, lens0
        produced = torch.zeros_like(budget)
        toks, logits = [], []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(POOL_STEPS):
            active = produced < budget
            lg, cache, ln = TF.decode_step_paged(cfg, params, cache, tk, ln,
                                                 active, tables=tables_)
            tk = torch.where(active, torch.argmax(lg, -1).to(torch.int32),
                             tk)
            produced += active.to(torch.int32)
            toks.append(tk)
            logits.append(lg)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / POOL_STEPS
        return torch.stack(toks), torch.stack(logits), cache, step_ms

    def chunk(cache):
        """api.decode_n(tables=) over the 16 steps; (tokens, pool, ms a
        step of the chunk, its gather and write-back included)."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        toks, cache, _, _ = api.decode_n(cfg, params, cache, feed, lens0,
                                         budget, num_steps=POOL_STEPS,
                                         tables=tables)
        torch.cuda.synchronize()
        return toks, cache, (time.perf_counter() - t0) * 1e3 / POOL_STEPS

    torch.cuda.reset_peak_memory_stats()
    pool_a = copy(start)
    DA.launches = DA.launches_bt = 0
    a_toks, a_logits, pool_a, a_ms = loop(pool_a, tables)
    launches = {"paged_decode_attention_bt": DA.launches_bt,
                "paged_decode_attention": DA.launches}
    check(launches["paged_decode_attention_bt"]
          >= cfg.num_layers * POOL_STEPS and not launches[
              "paged_decode_attention"],
          f"pooled decode launches {launches} for {POOL_STEPS} steps x "
          f"{cfg.num_layers} layers")
    check(tuple(a_logits.shape) == (POOL_STEPS, B, V)
          and bool(torch.isfinite(a_logits[:, :7]).all()),
          f"pooled logits {tuple(a_logits.shape)} not finite")
    b_toks, b_logits, _, b_ms = loop(TF.pool_view(copy(start), tables), None)
    check(torch.equal(a_logits[:, :7], b_logits[:, :7]),
          "pooled (row 3) and gathered-view (row 1) logits differ on the "
          "admitted slots")
    del b_logits
    c_toks, pool_c, c_ms = chunk(copy(start))
    check(torch.equal(a_toks, b_toks) and torch.equal(a_toks, c_toks),
          "pooled step loop, gathered-view loop and decode_n(tables=) "
          "tokens differ")
    check(torch.equal(pool_a.k, pool_c.k) and torch.equal(pool_a.v, pool_c.v),
          "the pooled step loop and decode_n(tables=) wrote other pools")
    written = torch.zeros((POOL_BLOCKS, POOL_BS), dtype=torch.bool,
                          device=dev)
    for b in range(B - 1):
        for r in range(plens[b], plens[b] + POOL_STEPS):
            written[int(t[b, r // POOL_BS]), r % POOL_BS] = True
    check(not bool(written[int(t[0, 0])].any()), "a decode row in the "
                                                 "shared block")
    for x, y in ((pool_a.k, start.k), (pool_a.v, start.v)):
        check(torch.equal(x[:, ~written], y[:, ~written]),
              "pooled decode changed a pool row it did not decode")
    peak = torch.cuda.max_memory_allocated() / 1e9
    del pool_a, pool_c, a_logits
    # the host sets a step's pace and varies: time the three again in
    # turns (A, B, C, C, B, A), each on a fresh copy of the pool
    turns = {"A": [a_ms], "B": [b_ms], "C": [c_ms]}
    for w in "ABCCBA":
        if w == "A":
            turns[w].append(loop(copy(start), tables)[3])
        elif w == "B":
            turns[w].append(loop(TF.pool_view(copy(start), tables), None)[3])
        else:
            turns[w].append(chunk(copy(start))[2])
    stats = {"step_ms_pooled": turns["A"], "step_ms_gathered_view": turns["B"],
             "step_ms_decode_n_chunk": turns["C"], "steps": POOL_STEPS,
             "prompt_lens": plens, "peak_mem_gb": peak,
             "rows_written": int(written.sum()), "launches": launches}
    return stats, launches


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
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


SERVE_SPEC = dict(slots=8, max_len=1024, prompt_len=128, chunk=8)
SERVE_NEW_TOKENS = 128


def serve_trace(np, vocab):
    """The serve phase's warm-up prompt (40 tokens) and its 16 requests'
    prompts of 32-128 tokens, from seed 0."""
    rng = np.random.default_rng(0)
    warm = rng.integers(0, vocab, size=40)
    return warm, [rng.integers(0, vocab, size=int(rng.integers(32, 129)))
                  for _ in range(16)]


def serve_phase(torch, np, cfg, api, engine_mod, DA, FA, dev="cuda"):
    t0 = time.perf_counter()
    params = api.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n_params = sum(t.numel() for t in _leaves(params))
    spec = engine_mod.SliceSpec(**SERVE_SPEC)
    warm_prompt, prompts = serve_trace(np, cfg.vocab_size)
    # warm-up (cuBLAS handles, allocator), outside the counted run
    warm = engine_mod.ServeEngine(cfg, params, spec, device=dev)
    warm.submit(warm_prompt, max_new_tokens=9)
    warm.run()
    del warm

    eng = engine_mod.ServeEngine(cfg, params, spec, device=dev)
    n_req, new_tokens = len(prompts), SERVE_NEW_TOKENS
    reqs = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
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


# benchmarks/kv_prefix.py's pooled spec and its shared-header traffic
KV_SPEC = dict(slots=8, max_len=288, prompt_len=256, chunk=8, kv_block=16,
               suffix_len=64)
KV_HEADER, KV_FEWSHOT, KV_REQUESTS, KV_NEW_TOKENS = 224, 16, 24, 32


def kv_prefix_trace(np, vocab, n=KV_REQUESTS, seed=0):
    """Shared-header prompts: one of 2 tiers' 224-token system header (14
    blocks of 16), on half the requests one of 2 16-token few-shot
    preambles, then a random tail of 8-32 tokens cut so that the prompt
    fits ``prompt_len`` (256; with a preamble the tail is 8-16 tokens)."""
    rng = np.random.default_rng(seed)
    headers = [rng.integers(0, vocab, KV_HEADER) for _ in range(2)]
    shots = [rng.integers(0, vocab, KV_FEWSHOT) for _ in range(2)]
    out = []
    for i in range(n):
        head = [headers[int(rng.integers(2))]]
        if i % 2:
            head.append(shots[int(rng.integers(2))])
        room = KV_SPEC["prompt_len"] - sum(len(h) for h in head)
        tail = rng.integers(0, vocab, int(rng.integers(8, min(32, room) + 1)))
        out.append(np.concatenate(head + [tail]))
    return out


def _engine_run(torch, engine_mod, cfg, params, spec, prompts, new_tokens,
                DA, FA, dev):
    """Serve ``prompts`` on a fresh engine with the launch counters zeroed
    just before ``run()`` and read just after: (engine, requests, stats,
    launches)."""
    eng = engine_mod.ServeEngine(cfg, params, spec, device=dev)
    reqs = [eng.submit(p, max_new_tokens=new_tokens) for p in prompts]
    torch.cuda.synchronize()
    DA.launches = DA.launches_bt = FA.launches = 0
    stats = eng.run()
    launches = {"paged_decode_attention": DA.launches,
                "paged_decode_attention_bt": DA.launches_bt,
                "flash_attention": FA.launches}
    check(stats["requests_done"] == len(prompts),
          f"served {stats['requests_done']} of {len(prompts)} requests")
    for r in reqs:
        check(r.done and len(r.out_tokens) == new_tokens
              and all(0 <= t < cfg.vocab_size for t in r.out_tokens),
              f"request {r.rid}: {len(r.out_tokens)} tokens of {new_tokens}"
              f" or a token outside the vocabulary")
    return eng, reqs, stats, launches


def pooled_engine_phase(torch, np, cfg, api, engine_mod, DA, FA, dev="cuda"):
    """Full-width olmo-1b in three engines on one shared-header trace (24
    requests, 32 new tokens each): pooled with sharing
    (``benchmarks/kv_prefix.py``'s spec), pooled with ``kv_share=False``,
    and the dense spec of the same envelope.  Share and no-share streams
    bitwise equal, ``kv_close`` leak-free for both, sharing cuts the
    prefill proxy and shares tokens; the pooled runs launch row 1 (decode
    over each chunk's gathered view) and never the flash kernel (their
    prefill is the plain ``blocked_attention``).  One suffix-prefill
    dispatch and one dense admission prefill are timed by CUDA events and
    the suffix dispatch profiled."""
    params = api.init_params(cfg, seed=0, device=dev)
    specs = {"share": engine_mod.SliceSpec(**KV_SPEC),
             "noshare": engine_mod.SliceSpec(**KV_SPEC, kv_share=False),
             "dense": engine_mod.SliceSpec(
                 **{k: v for k, v in KV_SPEC.items()
                    if k not in ("kv_block", "suffix_len")})}
    prompts = kv_prefix_trace(np, cfg.vocab_size)
    warm = kv_prefix_trace(np, cfg.vocab_size, n=3, seed=1)
    for spec in specs.values():              # cuBLAS handles, allocator
        _engine_run(torch, engine_mod, cfg, params, spec, warm, 4, DA, FA,
                    dev)[0].kv_close()
    torch.cuda.reset_peak_memory_stats()
    arms, streams = {}, {}
    for name, spec in specs.items():
        eng, reqs, stats, launches = _engine_run(
            torch, engine_mod, cfg, params, spec, prompts, KV_NEW_TOKENS, DA,
            FA, dev)
        streams[name] = [list(r.out_tokens) for r in reqs]
        stats.update(launches=launches, kv_stats=eng.kv_stats(),
                     ms_decode_chunk=stats["p50_chunk_s"] * 1e3,
                     prefill_dispatches=eng.prefill_flops_proxy
                     // (spec.slots * (spec.suffix_len or spec.prompt_len)))
        if spec.kv_block:
            check(launches["paged_decode_attention"]
                  >= cfg.num_layers * stats["decode_steps"]
                  and launches["flash_attention"] == 0
                  and launches["paged_decode_attention_bt"] == 0,
                  f"pooled engine ({name}) launches {launches} for "
                  f"{stats['decode_steps']} steps x {cfg.num_layers} layers")
            eng.kv_close()               # raises if a block leaked
            stats["blocks_leaked"] = eng.kvpool.stats()["allocated_blocks"]
        arms[name] = stats
        del eng, reqs
    peak = torch.cuda.max_memory_allocated() / 1e9
    check(streams["share"] == streams["noshare"],
          "pooled engine: sharing on and off served different tokens")
    share, noshare = arms["share"]["kv_stats"], arms["noshare"]["kv_stats"]
    check(share["prefill_flops_proxy"] < noshare["prefill_flops_proxy"]
          and share["kv_shared_tokens"] > 0,
          f"sharing did not cut the prefill proxy: {share} vs {noshare}")

    # one suffix-prefill dispatch at the engine's shape (rows resuming
    # after a shared header) and one dense admission prefill, on the card
    B, Tc, bs = KV_SPEC["slots"], KV_SPEC["suffix_len"], KV_SPEC["kv_block"]
    nb = KV_SPEC["max_len"] // bs
    pool = api.init_kv_pool(cfg, 2 * B * nb, bs, device=dev)
    tables = torch.arange(B * nb, dtype=torch.int32, device=dev).reshape(B,
                                                                         nb)
    g = torch.Generator(device=dev).manual_seed(7)
    toks = torch.randint(0, cfg.vocab_size, (B, Tc), generator=g, device=dev)
    start = np.full((B,), KV_HEADER, np.int32)
    valid = np.full((B,), 24, np.int32)
    suffix = lambda i: api.prefill_suffix(cfg, params, pool, toks, start,
                                          valid, tables)
    dense_toks = torch.randint(0, cfg.vocab_size, (B, KV_SPEC["prompt_len"]),
                               generator=g, device=dev)
    dense = lambda i: api.prefill(cfg, params, {"tokens": dense_toks},
                                  max_len=KV_SPEC["max_len"])
    DA.launches = FA.launches = 0
    lg, _ = suffix(0)
    check(tuple(lg.shape) == (B, cfg.vocab_size)
          and bool(torch.isfinite(lg).all()) and FA.launches == 0,
          "suffix prefill: logits not finite or a kernel launched")
    ms = {"suffix_prefill": cuda_ms(torch, suffix, 1, iters=10),
          "dense_prefill": cuda_ms(torch, dense, 1, iters=10)}
    arms["share"]["ms_prefill_dispatch"] = ms["suffix_prefill"]
    arms["noshare"]["ms_prefill_dispatch"] = ms["suffix_prefill"]
    arms["dense"]["ms_prefill_dispatch"] = ms["dense_prefill"]
    out = {"arms": arms, "requests": len(prompts),
           "prompt_lens": [len(p) for p in prompts],
           "bitwise_share_noshare": True, "peak_mem_gb": peak,
           "dense_equals_pooled_streams": streams["dense"] == streams["share"],
           "suffix_prefill_profile": profile_busy(torch, lambda: suffix(0))}
    return out, {n: a["launches"] for n, a in arms.items()}


def int8_engine_phase(torch, np, cfg, api, engine_mod, QU, DA, FA,
                      dev="cuda"):
    """Full-width olmo-1b with int8 weights (``SliceSpec(quant="int8")``)
    on the serve phase's 16 requests, counted: rows 1 and 2 launched; then
    an engine on ``dequantize_params`` of the same quantised tree serves
    the same tokens, bit for bit.  Weight storage bytes against the bf16
    tree's, and the device time a decode step of each engine takes (the
    int8 engine dequantises every weight at its use)."""
    params = api.init_params(cfg, seed=0, device=dev)
    spec = engine_mod.SliceSpec(**SERVE_SPEC, quant="int8")
    warm_prompt, prompts = serve_trace(np, cfg.vocab_size)
    _engine_run(torch, engine_mod, cfg, params, spec, [warm_prompt], 9, DA,
                FA, dev)
    torch.cuda.reset_peak_memory_stats()
    eng, reqs, stats, launches = _engine_run(
        torch, engine_mod, cfg, params, spec, prompts, SERVE_NEW_TOKENS, DA,
        FA, dev)
    stats["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 1e9
    check(launches["paged_decode_attention"]
          >= cfg.num_layers * stats["decode_steps"]
          and launches["flash_attention"] >= cfg.num_layers,
          f"int8 engine launches {launches}")
    int8_bytes = eng.weight_stream_bytes()
    bf16_bytes = QU.storage_bytes(params)
    ratio = int8_bytes / bf16_bytes
    check(0.5 < ratio < 0.53, f"int8 weight bytes {int8_bytes} are "
                              f"{ratio:.4f} of bf16's {bf16_bytes}")
    mat = QU.dequantize_params(eng.params)
    prof = profile_chunk(torch, np, cfg, params, engine_mod, spec)
    del params
    dense_spec = engine_mod.SliceSpec(**SERVE_SPEC)
    _, mreqs, mstats, _ = _engine_run(
        torch, engine_mod, cfg, mat, dense_spec, prompts, SERVE_NEW_TOKENS,
        DA, FA, dev)
    check([r.out_tokens for r in reqs] == [r.out_tokens for r in mreqs],
          "int8 engine and its dequantised tree served different tokens")
    mprof = profile_chunk(torch, np, cfg, mat, engine_mod, dense_spec)
    if "device_busy_ms" in prof and "device_busy_ms" in mprof:
        stats["dequant_device_ms_per_step"] = (
            prof["device_busy_ms"] - mprof["device_busy_ms"]) / spec.chunk
    stats.update(profile=prof, dequantized_profile=mprof)
    stats.update(launches=launches, weight_stream_bytes=int8_bytes,
                 bf16_weight_stream_bytes=bf16_bytes,
                 weight_bytes_ratio=ratio, bitwise_dequantized=True,
                 dequantized_tokens_per_s=mstats["tokens_per_s"],
                 dequantized_mean_ttft_s=mstats["mean_ttft_s"])
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


def profile_busy(torch, fn, top=6):
    """The card's busy and idle share over one call of ``fn`` (after a warm
    call): summed device kernel time from torch.profiler over the wall
    time of the same call unprofiled."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name = {}
    for e in dev_events:
        by_name[e.name] = by_name.get(e.name, 0.0) + \
            e.time_range.elapsed_us() / 1e3
    busy_ms = sum(by_name.values())
    if not dev_events or busy_ms <= 0:
        return {"device_time": "not measured (no device events recorded)"}
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_ms": wall * 1e3, "device_busy_ms": busy_ms,
            "device_idle_share": max(0.0, 1.0 - busy_ms / (wall * 1e3)),
            "device_events": len(dev_events),
            "top_device_ms": [[n[:70], t] for n, t in top]}


def dlrm_reference_phase(torch, registry, api, ShapeConfig, FL, EG,
                         dev="cuda"):
    """Reduced dlrm0, same weights and batch: CPU (plain) vs card
    (kernels), both lookup routes."""
    cfg = registry.get_reduced("dlrm0")
    p_cpu = api.init_params(cfg, seed=0, device="cpu")
    b_cpu = api.make_batch(cfg, ShapeConfig("dlrm_check", "prefill", 1, 64),
                           seed=1, device="cpu")
    p_gpu, b_gpu = _to(p_cpu, dev), _to(b_cpu, dev)
    worst = (0.0, 0.0, 0.0)                 # (err / tol, err, tol)
    f0, g0 = FL.launches, EG.launches
    for fused in (True, False):
        want = api.forward(cfg, p_cpu, b_cpu, fused=fused)[0]
        with torch.inference_mode():
            got = api.forward(cfg, p_gpu, b_gpu, fused=fused)[0].cpu()
        check(got.shape == want.shape == (64,)
              and bool(torch.isfinite(got).all()),
              f"dlrm reference (fused={fused}): logits {tuple(got.shape)} "
              f"not finite")
        tol = LOGIT_REL_TOL * want.abs().max().item()
        err = (got - want).abs().max().item()
        check(err <= tol, f"dlrm reference (fused={fused}): card vs CPU "
                          f"logits differ by {err:.4g} > {tol:.4g}")
        worst = max(worst, (err / tol, err, tol))
    check(FL.launches > f0 and EG.launches >= g0 + len(cfg.dlrm.tables),
          "dlrm reference: the card's forward did not reach the kernels")
    return worst


def emb_small_cases(torch, FL, EG, EL, ES, QU, REF, dev="cuda"):
    """Edge cases of the embedding kernels against their plain versions:
    the fused lookup (f32 and int8 at every dlrm0 width), the row gather,
    the single-table lookup and the scatter of deduplicated ids."""
    gen = torch.Generator(device=dev).manual_seed(2)
    dims = (32, 64, 96, 128, 192, 256)
    groups = [torch.randn((r, d), generator=gen, device=dev)
              for r, d in zip((300, 50, 7, 1000, 20, 64), dims)]
    # (group, valency, mean): valency 1 and 128, sum and mean, every dim
    spec = [(0, 1, 0), (0, 128, 1), (1, 10, 1), (2, 32, 0), (3, 128, 0),
            (4, 1, 1), (5, 100, 1), (5, 128, 0), (3, 3, 1), (1, 1, 0)]
    B = 17
    slots, cols, c0 = [], [], 0
    for g, w, mean in spec:
        slots.append((g, c0, c0 + w, mean))
        cols.append(torch.randint(-1, groups[g].shape[0], (B, w),
                                  generator=gen, device=dev))
        c0 += w
    rows = torch.cat(cols, dim=1).to(torch.int32)
    rows[0, slots[1][1]:slots[1][2]] = -1      # mean slot, count 0
    rows[0, slots[3][1]:slots[3][2]] = -1      # sum slot, every id -1
    rows[1, slots[4][1]:slots[4][2]] = 5       # one row repeated 128 times
    rows[2, slots[6][1]:slots[6][2]:2] = 3     # repeated rows among others
    rows[3, :] = -1                            # a sample with no value
    slot_t = torch.tensor(slots, dtype=torch.int32, device=dev)
    got = FL.fused_lookup(groups, rows, slot_t, 256)
    want = REF.fused_lookup_ref(groups, rows, slot_t, 256)
    err_f = max_err(torch, got, want, "fused lookup, small cases",
                    EMB_ATOL, EMB_RTOL)
    check(not got[3].any() and not got[0, 1].any() and not got[0, 3].any(),
          "fused lookup: a slot with no valid id is not zero")
    for k, (g, _, _, _) in enumerate(slots):
        check(not got[:, k, dims[g]:].any(),
              f"fused lookup: lanes past dim {dims[g]} of slot {k} not zero")
    err_g = 0.0
    for V, D, Bg, Vl in ((300, 32, 5, 1), (1000, 128, 9, 128),
                         (7, 96, 4, 10), (64, 256, 3, 100)):
        table = torch.randn((V, D), generator=gen, device=dev)
        ids = torch.randint(-1, V, (Bg, Vl), generator=gen, device=dev
                            ).to(torch.int32)
        ids[0] = -1
        got = EG.embedding_gather(table, ids)
        err_g = max(err_g, max_err(torch, got,
                                   REF.embedding_gather_ref(table, ids),
                                   f"row gather V{V} D{D} B{Bg} Vl{Vl}",
                                   EMB_ATOL, EMB_RTOL))
        check(not got[0].any(), "row gather: ids -1 gave a non-zero row")
    # int8 fused lookup: the same descriptors over the quantised groups
    qts = [QU.quantize_row_space(g) for g in groups]
    qg, qs = [q.q for q in qts], [q.scale for q in qts]
    got = FL.fused_lookup_q(qg, qs, rows, slot_t, 256)
    err_q = max_err(torch, got, REF.fused_lookup_q_ref(qg, qs, rows, slot_t,
                                                       256),
                    "int8 fused lookup, small cases", EMB_ATOL, EMB_RTOL)
    check(not got[3].any() and not got[0, 1].any() and not got[0, 3].any(),
          "int8 fused lookup: a slot with no valid id is not zero")
    check_int8_bound(torch, REF, got, FL.fused_lookup(groups, rows, slot_t,
                                                      256),
                     qs, rows, slot_t, "int8 fused lookup, small cases")
    # single-table lookup at the fig9 shape (benchmarks/fig9_sparsecore.py),
    # a sample with every id -1, a row repeated over the span
    table = torch.randn((8192, 64), generator=gen, device=dev)
    ids = torch.randint(-1, 8192, (64, 16), generator=gen, device=dev
                        ).to(torch.int32)
    ids[0] = -1
    ids[1] = 77
    err_l = 0.0
    for comb in ("sum", "mean"):
        got = EL.embedding_lookup(table, ids, comb)
        err_l = max(err_l, max_err(torch, got,
                                   REF.embedding_lookup_ref(table, ids, comb),
                                   f"embedding lookup fig9 shape {comb}",
                                   EMB_ATOL, EMB_RTOL))
        check(not got[0].any(), "embedding lookup: all ids -1, not zero")
    # scatter: unique sorted ids with a -1 tail, and a sorted stream with
    # adjacent duplicates, a -1 tail and ids past V; bitwise the plain
    # version in index order (deterministic algorithms)
    V, D = 5000, 96
    uniq = torch.cat([torch.randperm(V, generator=gen, device=dev)[:1500]
                      .sort().values, torch.full((500,), -1, device=dev)])
    dup = torch.cat([torch.randint(0, V, (3000,), generator=gen, device=dev)
                     .sort().values, torch.tensor([V, V + 9], device=dev),
                     torch.full((40,), -1, device=dev)])
    for what, sid in (("unique ids", uniq), ("adjacent duplicates", dup)):
        sid = sid.to(torch.int32)
        grads = torch.randn((sid.numel(), D), generator=gen, device=dev)
        got = ES.embedding_scatter(grads, sid, V)
        with deterministic(torch):
            want = REF.embedding_scatter_ref(grads, sid, V)
        scatter_bitwise(torch, [got], [want], f"embedding scatter, {what}")
        check(torch.equal(got.cpu(), REF.embedding_scatter_ref(
            grads.cpu(), sid.cpu(), V)), f"embedding scatter, {what}: not "
                                         f"bitwise the CPU's sequential sum")
    return err_f, err_g, err_q, err_l


def rows_by_group(torch, plan, groups, rows):
    """(valid ids, distinct valid rows) of ``rows`` per row space: what a
    lookup of this batch must read."""
    col_group = torch.tensor([g for g, a, b, _ in plan.slot_table
                              for _ in range(a, b)], device=rows.device)
    out = []
    for gi in range(len(groups)):
        ids = rows[:, col_group == gi]
        ids = ids[ids >= 0]
        out.append((ids.numel(), int(torch.unique(ids).numel())))
    return out


def _bag_inputs(torch, plan, groups, rows):
    """``F.embedding_bag`` inputs computing the fused lookup per row space:
    flat ids, bag offsets and per-id weights (0 for an invalid id, 1/count
    in a mean slot)."""
    B, dev = rows.shape[0], rows.device
    bags = []
    for gi, table in enumerate(groups):
        spans = [(a, b, m) for g, a, b, m in plan.slot_table if g == gi]
        if not spans:
            continue
        ids = torch.cat([rows[:, a:b] for a, b, _ in spans], dim=1)
        w = (ids >= 0).float()
        starts, c0 = [], 0
        for a, b, mean in spans:
            if mean:
                part = w[:, c0:c0 + b - a]
                part /= part.sum(dim=1, keepdim=True).clamp_min(1.0)
            starts.append(c0)
            c0 += b - a
        offsets = (torch.arange(B, device=dev)[:, None] * c0
                   + torch.tensor(starts, device=dev)[None, :]).reshape(-1)
        bags.append((table, ids.clamp_min(0).reshape(-1).long(), offsets,
                     w.reshape(-1)))
    return bags


def digest(tensors):
    """sha256 of the tensors' bytes, in order: whether two source trees'
    kernels give the same bits on the same inputs."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def dlrm_kernel_phase(torch, F, cfg, coll, tables, DL, ShapeConfig, FL, EG,
                      EL, REF, ops, B, dev="cuda", digests=False):
    """The lookup kernels at the one-card dlrm0's tables and batch B (the
    fused lookup, the row gather and the single-table lookup): held
    against their plain versions, timed beside them, their byte bound and
    a PyTorch yardstick.  ``digests``: each kernel's result also gets the
    `digest` of its output on the first batch (``sha256``)."""
    shape = ShapeConfig("dlrm_kernels", "prefill", 1, B)
    feats = []
    for seed in (10, 11):
        batch = DL.make_batch(cfg, shape,
                              torch.Generator(device=dev).manual_seed(seed))
        feats.append({t.name: batch[f"cat_{t.name}"]
                      for t in cfg.dlrm.tables})
        del batch
    fused_in = [coll.fused_inputs(tables, f) for f in feats]
    plan = fused_in[0][0]
    K, dmax = len(plan.fslots), plan.dmax
    out = {}
    with torch.inference_mode():
        # -- fused lookup ---------------------------------------------------
        _, groups, rows, slots = fused_in[0]
        got = FL.fused_lookup(groups, rows, slots, dmax)
        err = max_err(torch, got,
                      REF.fused_lookup_ref(groups, rows, slots, dmax),
                      f"fused lookup at B={B}", EMB_ATOL, EMB_RTOL)
        sha = digest([got]) if digests else None
        del got
        args = [(g, r, sl, dmax) for _, g, r, sl in fused_in]
        ms = cuda_ms(torch, lambda i: FL.fused_lookup(*args[i]), 2, iters=20)
        plain_ms = cuda_ms(torch, lambda i: REF.fused_lookup_ref(*args[i]),
                           2, iters=5, warmup=1)
        # bytes: each distinct row once (the Zipf ids repeat rows within a
        # batch), every id once, the (B, K, Dmax) output once; operations:
        # one add per lane of every valid id
        counts = rows_by_group(torch, plan, groups, rows)
        valid_rows = sum(v for v, _ in counts)
        distinct_rows = sum(n for _, n in counts)
        valid_elems = sum(v * g.shape[1] for (v, _), g in zip(counts, groups))
        distinct_elems = sum(n * g.shape[1]
                             for (_, n), g in zip(counts, groups))
        nbytes = (distinct_elems * 4 + rows.numel() * 4 + B * K * dmax * 4
                  + K * 16)
        bound_ms, bound_by = bound(nbytes, valid_elems, F32_FLOPS_PER_S)
        bags = [_bag_inputs(torch, p, g, r) for p, g, r, _ in fused_in]

        def library(i):
            for table, ids, offs, w in bags[i]:
                F.embedding_bag(ids, table, offs, mode="sum",
                                per_sample_weights=w)

        library_ms = cuda_ms(torch, library, 2, iters=10)
        del bags
        out["fused_lookup"] = dict(
            name="fused_lookup", route="cuda",
            source="src/repro_torch/kernels/csrc/fused_lookup.cu",
            replaces="src/repro/kernels/embedding_lookup.py:207",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=library_ms, batch=B,
            valid_rows=valid_rows, distinct_rows=distinct_rows,
            bytes=nbytes, sha256=sha)
        del fused_in, args, rows, groups
        # -- row gather: one launch per table, as the per-table route -----
        sets = [[(coll.table_view(tables, t), f[t.name])
                 for t in cfg.dlrm.tables] for f in feats]
        err = 0.0
        h = hashlib.sha256()
        for view, ids in sets[0]:
            got = EG.embedding_gather(view, ids)
            err = max(err, max_err(torch, got,
                                   REF.embedding_gather_ref(view, ids),
                                   f"row gather at B={B}", EMB_ATOL,
                                   EMB_RTOL))
            if digests:
                h.update(digest([got]).encode())
            del got

        def each(fn, i, sets=sets):
            for args in sets[i]:
                fn(*args)

        ms = cuda_ms(torch, lambda i: each(EG.embedding_gather, i), 2,
                     iters=10)
        plain_ms = cuda_ms(torch, lambda i: each(REF.embedding_gather_ref, i),
                           2, iters=5, warmup=1)
        clamped = [[(ids.clamp_min(0), view) for view, ids in st]
                   for st in sets]        # F.embedding(ids, table)
        library_ms = cuda_ms(torch, lambda i: each(F.embedding, i, clamped),
                             2, iters=10)
        # bytes: each table's distinct rows once, every id once, the
        # (B, Vl, D) output once
        valid_rows = sum(int((ids >= 0).sum()) for _, ids in sets[0])
        distinct = [int(torch.unique(ids[ids >= 0]).numel())
                    for _, ids in sets[0]]
        distinct_elems = sum(n * view.shape[1]
                             for n, (view, _) in zip(distinct, sets[0]))
        out_elems = sum(ids.numel() * view.shape[1] for view, ids in sets[0])
        nbytes = (distinct_elems + out_elems) * 4 + sum(
            ids.numel() * 4 for _, ids in sets[0])
        bound_ms, bound_by = bound(nbytes, 0)
        out["embedding_gather"] = dict(
            name="embedding_gather", route="cuda",
            source="src/repro_torch/kernels/csrc/embedding_gather.cu",
            replaces="src/repro/kernels/embedding_lookup.py:57",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=library_ms, batch=B,
            launches_timed=len(sets[0]), valid_rows=valid_rows,
            distinct_rows=sum(distinct), bytes=nbytes,
            sha256=h.hexdigest() if digests else None)
        del clamped
        # -- single-table lookup: one launch per table through ops (this
        # slice's path), counted; held against its plain version and the
        # per-table route (gather kernel + _combine) --------------------
        lsets = [[(view, ids, t.combiner) for t, (view, ids) in
                  zip(cfg.dlrm.tables, st)] for st in sets]
        EL.launches = 0
        path = [ops.embedding_lookup(*x) for x in lsets[0]]
        torch.cuda.synchronize()
        launches = EL.launches
        check(launches == len(lsets[0]), f"embedding lookup at B={B}: "
                                         f"{launches} launches for "
                                         f"{len(lsets[0])} tables")
        per_table = coll.lookup(tables, feats[0], fused=False)
        err = err_route = 0.0
        for t, got, x in zip(cfg.dlrm.tables, path, lsets[0]):
            err = max(err, max_err(torch, got, REF.embedding_lookup_ref(*x),
                                   f"embedding lookup at B={B}", EMB_ATOL,
                                   EMB_RTOL))
            err_route = max(err_route, max_err(
                torch, got, per_table[t.name], f"embedding lookup vs the "
                f"per-table route at B={B}", EMB_ATOL, EMB_RTOL))
        sha = digest(path) if digests else None
        del path, per_table
        # 150 wrapper calls a batch: 4 batches timed, so the host queues
        # every launch behind the spin (`host` says whether it did)
        host = {}
        ms = cuda_ms(torch, lambda i: each(EL.embedding_lookup, i, lsets), 2,
                     iters=4, host=host)
        plain_ms = cuda_ms(torch, lambda i: each(REF.embedding_lookup_ref, i,
                                                 lsets), 2, iters=5, warmup=1)
        bags = []                   # F.embedding_bag(ids, table, weights)
        for st in lsets:
            per = []
            for view, ids, comb in st:
                w = (ids >= 0).float()
                if comb == "mean":
                    w /= w.sum(dim=1, keepdim=True).clamp_min(1.0)
                per.append((ids.clamp_min(0).long(), view, w))
            bags.append(per)
        library_ms = cuda_ms(torch, lambda i: [
            F.embedding_bag(ids, view, mode="sum", per_sample_weights=w)
            for ids, view, w in bags[i]], 2, iters=4)
        del bags
        # bytes: each table's distinct rows once, every id once, the (B, D)
        # output once; operations: one add per lane of every valid id
        valid_elems = sum(int((ids >= 0).sum()) * view.shape[1]
                          for view, ids in sets[0])
        nbytes = (distinct_elems + sum(B * view.shape[1]
                                       for view, _ in sets[0])) * 4 + sum(
            ids.numel() * 4 for _, ids in sets[0])
        bound_ms, bound_by = bound(nbytes, valid_elems, F32_FLOPS_PER_S)
        out["embedding_lookup"] = dict(
            name="embedding_lookup", route="cuda",
            source="src/repro_torch/kernels/csrc/embedding_lookup.cu",
            replaces="src/repro/kernels/embedding_lookup.py:109",
            launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
            batch=B, max_abs_err_vs_per_table_route=err_route,
            launches_timed=len(lsets[0]), valid_rows=valid_rows,
            distinct_rows=sum(distinct), bytes=nbytes, sha256=sha,
            host_ms_a_batch=host["host_ms"],
            queue_ahead_ms=host["queue_ahead_ms"],
            host_bound=host["host_bound"])
    return out


def int8_lookup_phase(torch, cfg, coll, tables, DL, ShapeConfig, FL, QU,
                      REF, ops, dev="cuda", digests=False):
    """The int8 fused lookup at full width: the resident scoring row
    spaces quantised with ``quantize_row_space`` block by block (at most
    one f32 block's tile extra), then ``ops.fused_lookup_q`` at B = 256
    and 4096 on the scoring phase's descriptors (counted), held against
    its plain version on the card and, within the int8 bound, the f32
    fused lookup on the same batch; timed beside both."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    qt = {k: QU.quantize_row_space(v)
          for k, v in tables.items()}
    torch.cuda.synchronize()
    stats = {"quantize_s": time.perf_counter() - t0,
             "int8_gb": sum(q.q.numel() for q in qt.values()) / 1e9,
             "scales_gb": sum(q.scale.numel() * 4 for q in qt.values()) / 1e9,
             "quantize_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    launches = 0
    for B in (DLRM_CHIP_BATCH, DLRM_BATCH):
        shape = ShapeConfig("dlrm_int8", "prefill", 1, B)
        ins = []
        for seed in (20, 21):
            batch = DL.make_batch(cfg, shape, torch.Generator(
                device=dev).manual_seed(seed))
            plan, groups, rows, slots = coll.fused_inputs(
                tables, {t.name: batch[f"cat_{t.name}"]
                         for t in cfg.dlrm.tables})
            ins.append(([qt[k].q for k in plan.keys],
                        [qt[k].scale for k in plan.keys], groups, rows,
                        slots))
            del batch
        dmax, K = plan.dmax, len(plan.fslots)
        qg, qs, groups, rows, slots = ins[0]
        with torch.inference_mode():
            FL.launches_q = 0
            got = ops.fused_lookup_q(qg, qs, rows, slots, dmax)
            torch.cuda.synchronize()
            n = FL.launches_q
            check(n == 1, f"int8 fused lookup at B={B}: {n} launches for "
                          f"one batch")
            launches += n
            err = max_err(torch, got, REF.fused_lookup_q_ref(
                qg, qs, rows, slots, dmax), f"int8 fused lookup at B={B}",
                EMB_ATOL, EMB_RTOL)
            used = check_int8_bound(
                torch, REF, got, FL.fused_lookup(groups, rows, slots, dmax),
                qs, rows, slots, f"int8 fused lookup at B={B}")
            again = FL.fused_lookup_q(qg, qs, rows, slots, dmax)
            check(torch.equal(got, again), f"int8 fused lookup at B={B}: "
                                           f"two launches differ")
            sha = digest([got]) if digests else None
            del got, again
            ms = cuda_ms(torch, lambda i: FL.fused_lookup_q(
                *ins[i][:2], *ins[i][3:], dmax), 2, iters=20)
            f32_ms = cuda_ms(torch, lambda i: FL.fused_lookup(
                *ins[i][2:], dmax), 2, iters=20)
            plain_ms = cuda_ms(torch, lambda i: REF.fused_lookup_q_ref(
                *ins[i][:2], *ins[i][3:], dmax), 2, iters=5, warmup=1)
        # bytes: each distinct row's int8 lanes and its scales once, every
        # id once, the (B, K, dmax) output once; operations: a multiply
        # and an add per lane of every valid id
        counts = rows_by_group(torch, plan, qg, rows)
        nbytes = sum(nd * (q.shape[1] + s.shape[1] * 4)
                     for (_, nd), q, s in zip(counts, qg, qs)) \
            + rows.numel() * 4 + B * K * dmax * 4 + K * 16
        ops_n = 2 * sum(v * q.shape[1] for (v, _), q in zip(counts, qg))
        bound_ms, bound_by = bound(nbytes, ops_n, F32_FLOPS_PER_S)
        stats[B] = dict(
            name="fused_lookup_q", route="cuda",
            source="src/repro_torch/kernels/csrc/fused_lookup.cu",
            replaces="src/repro/kernels/embedding_lookup.py:170",
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None, batch=B,
            f32_fused_lookup_ms=f32_ms, int8_bound_share_used=used,
            sha256=sha,
            valid_rows=sum(v for v, _ in counts),
            distinct_rows=sum(nd for _, nd in counts), bytes=nbytes)
        del ins, qg, qs, groups, rows, slots
    peak = torch.cuda.max_memory_allocated()
    stats["peak_mem_gb"] = peak / 1e9
    stats["launches"] = launches
    check(peak < INT8_PEAK_LIMIT, f"int8 lookup: peak allocated "
                                  f"{peak / 1e9:.2f} GB >= "
                                  f"{INT8_PEAK_LIMIT / 1e9:.0f} GB")
    del qt
    return stats


def dlrm_score_phase(torch, cfg, params, coll, api, ShapeConfig, FL, EG,
                     n_fused=20, n_legacy=3, dev="cuda"):
    """The DLRM scoring path at B = DLRM_BATCH through both lookup
    routes; counters zeroed just before and read just after."""
    shape = ShapeConfig("dlrm_score", "prefill", 1, DLRM_BATCH)
    with torch.inference_mode():           # warm-up, outside the count
        batch = api.make_batch(cfg, shape, seed=100, device=dev)
        for fused in (True, False):
            api.forward(cfg, params, batch, coll=coll, fused=fused)
        del batch
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    times = {True: [], False: []}
    kept = {}
    FL.launches = EG.launches = 0
    with torch.inference_mode():
        for i in range(n_fused + n_legacy):
            fused = i < n_fused
            seed = 200 + (i if fused else i - n_fused)
            batch = api.make_batch(cfg, shape, seed=seed, device=dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits, _ = api.forward(cfg, params, batch, coll=coll,
                                    fused=fused)
            torch.cuda.synchronize()
            times[fused].append(time.perf_counter() - t0)
            check(tuple(logits.shape) == (DLRM_BATCH,)
                  and bool(torch.isfinite(logits).all()),
                  f"dlrm scoring: logits {tuple(logits.shape)} not finite")
            if seed - 200 < n_legacy:
                kept[(fused, seed)] = logits.cpu()
            del batch, logits
    launches = {"fused_lookup": FL.launches, "embedding_gather": EG.launches}
    peak = torch.cuda.max_memory_allocated()
    n_tables = len(cfg.dlrm.tables)
    check(launches["fused_lookup"] == n_fused,
          f"fused lookup launched {launches['fused_lookup']} times for "
          f"{n_fused} batches")
    check(launches["embedding_gather"] == n_legacy * n_tables,
          f"row gather launched {launches['embedding_gather']} times for "
          f"{n_legacy} batches x {n_tables} tables")
    worst = (0.0, 0.0, 0.0)
    for seed in range(200, 200 + n_legacy):
        a, b = kept[(True, seed)], kept[(False, seed)]
        tol = LOGIT_REL_TOL * a.abs().max().item()
        err = (a - b).abs().max().item()
        check(err <= tol, f"dlrm scoring: fused and per-table logits differ "
                          f"by {err:.4g} > {tol:.4g} (batch seed {seed})")
        worst = max(worst, (err / tol, err, tol))
    check(peak < 52e9, f"dlrm scoring: peak allocated {peak / 1e9:.2f} GB "
                       f">= 52 GB (a copy of the tables?)")
    with torch.inference_mode():
        batch = api.make_batch(cfg, shape, seed=300, device=dev)
        prof = profile_busy(torch, lambda: api.forward(cfg, params, batch,
                                                       coll=coll))
        del batch
    fused_s, legacy_s = sum(times[True]), sum(times[False])
    stats = {
        "batch": DLRM_BATCH, "batches_fused": n_fused,
        "batches_per_table": n_legacy,
        "samples_per_s_fused": DLRM_BATCH * n_fused / fused_s,
        "samples_per_s_per_table": DLRM_BATCH * n_legacy / legacy_s,
        "ms_per_batch_fused": [t * 1e3 for t in times[True]],
        "ms_per_batch_per_table": [t * 1e3 for t in times[False]],
        "median_ms_fused": sorted(times[True])[n_fused // 2] * 1e3,
        "median_ms_per_table": sorted(times[False])[n_legacy // 2] * 1e3,
        "peak_mem_gb": peak / 1e9,
        "fused_vs_per_table_logits": {"max_err": worst[1],
                                      "tolerance": worst[2]},
        "profile_fused_batch": prof,
    }
    return stats, launches


def dlrm0_cut(registry, table_params):
    """dlrm0 with its vocabularies cut to ``table_params`` f32 table
    parameters; tables, dims, valencies, combiners and tower as published."""
    import dataclasses
    from repro_torch.configs import dlrm0
    base = registry.get_config("dlrm0")
    return base.replace(dlrm=dataclasses.replace(
        base.dlrm, tables=dlrm0._table_specs(target_params=table_params)))


def dlrm_phases(torch, F, registry, api, DL, ShapeConfig, FL, EG, EL, ES,
                QU, REF, ops, dev="cuda"):
    worst = dlrm_reference_phase(torch, registry, api, ShapeConfig, FL, EG,
                                 dev)
    log(f"dlrm reference: card vs CPU logits differ by at most "
        f"{worst[1]:.3e} (tolerance {worst[2]:.3e} at that route)")
    small = emb_small_cases(torch, FL, EG, EL, ES, QU, REF, dev)
    log(f"dlrm kernels, small cases: max |err| fused {small[0]:.3e}, "
        f"gather {small[1]:.3e}, int8 fused {small[2]:.3e}, lookup "
        f"{small[3]:.3e}; the scatter of deduplicated ids bitwise")
    cfg = dlrm0_cut(registry, DLRM_TABLE_PARAMS)
    n_emb = sum(t.vocab_size * t.dim for t in cfg.dlrm.tables)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = api.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    info = {"init_s": time.perf_counter() - t0, "emb_params": n_emb,
            "emb_gb": n_emb * 4 / 1e9,
            "dense_params": sum(t.numel() for t in _leaves(
                [params["bottom"], params["top"]])),
            "init_peak_gb": torch.cuda.max_memory_allocated() / 1e9}
    check(sum(t.numel() for t in params["tables"].values()) == n_emb,
          "dlrm0 tables: row spaces do not hold every table")
    log("dlrm0 (one card):", json.dumps(info))
    coll = DL.collection_for(cfg)
    kern = {}
    for B in (DLRM_CHIP_BATCH, DLRM_BATCH):
        kern[B] = dlrm_kernel_phase(torch, F, cfg, coll, params["tables"], DL,
                                    ShapeConfig, FL, EG, EL, REF, ops, B,
                                    dev)
        log(f"dlrm kernels at B={B}:", json.dumps(kern[B]))
        torch.cuda.empty_cache()
    stats, launches = dlrm_score_phase(torch, cfg, params, coll, api,
                                       ShapeConfig, FL, EG, dev=dev)
    stats.update(info)
    log("dlrm scoring:", json.dumps(stats))
    torch.cuda.empty_cache()
    int8 = int8_lookup_phase(torch, cfg, coll, params["tables"], DL,
                             ShapeConfig, FL, QU, REF, ops, dev)
    log("int8 fused lookup:", json.dumps({str(k): v
                                          for k, v in int8.items()}))
    return kern, stats, launches, int8


@contextlib.contextmanager
def deterministic(torch):
    """``torch.use_deterministic_algorithms`` on inside: the plain
    scatter's ``index_add_`` then sorts its indices stably and sums each
    row's duplicates in index order, the fused scatter's order."""
    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)


def scatter_bitwise(torch, got, want, what):
    """Fails unless every row space of ``got`` is finite and bitwise
    ``want`` (tolerance 0: both sum each row in (b, s) order); returns
    the max |kernel - plain|, 0.0."""
    torch.cuda.synchronize()
    worst = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        check(g.shape == w.shape, f"{what}: row space {i} shape "
                                  f"{tuple(g.shape)} != {tuple(w.shape)}")
        check(bool(torch.isfinite(g).all()), f"{what}: non-finite gradient")
        err = (g - w).abs().max().item()
        check(torch.equal(g, w), f"{what}: row space {i} is not bitwise the "
                                 f"ordered plain sum (max |kernel - plain| "
                                 f"{err:.3e})")
        worst = max(worst, err)
    return worst


def scatter_small_cases(torch, FS, REF, dev="cuda"):
    """Edge cases of the fused scatter against its plain version, bitwise:
    on the CPU (sequential (b, s) order) and on the card (deterministic
    algorithms); two launches bitwise equal."""
    gen = torch.Generator(device=dev).manual_seed(3)
    cases = [  # row-space shapes, (group, valency, mean) per slot, B
        ([(300, 32), (50, 64), (7, 96), (1000, 128), (20, 192), (64, 256)],
         [(0, 1, 0), (0, 128, 1), (1, 10, 1), (2, 32, 0), (3, 128, 0),
          (4, 1, 1), (5, 100, 1), (5, 128, 0), (3, 3, 1), (1, 1, 0)], 17),
        ([(50, 32), (20, 256)], [(0, 1, 0), (1, 5, 1), (0, 3, 0)], 10_000),
        ([(9, 4), (40, 8)], [(1, 3, 1), (0, 6, 0), (1, 1, 0)], 64),
    ]
    worst = 0.0
    for shapes, spec, B in cases:
        slots, cols, c0 = [], [], 0
        for g, w, mean in spec:
            slots.append((g, c0, c0 + w, mean))
            cols.append(torch.randint(-1, shapes[g][0], (B, w),
                                      generator=gen, device=dev))
            c0 += w
        rows = torch.cat(cols, dim=1).to(torch.int32)
        if B == 10_000:
            rows[:, 0] = 3                     # one row named 10,000 times
            rows[::7, 1:] = -1
        else:
            rows[0, :] = -1                    # a sample with no value
            rows[1, slots[1][1]:slots[1][2]] = 2
        slot_t = torch.tensor(slots, dtype=torch.int32, device=dev)
        col_slot = REF.column_slots(slot_t, c0).int()
        dmax = max(d for _, d in shapes)
        gout = torch.randn((B, len(spec), dmax), generator=gen, device=dev)
        what = f"fused scatter, small case B={B}"
        got = FS.fused_scatter(gout, rows, slot_t, col_slot, shapes)
        again = FS.fused_scatter(gout, rows, slot_t, col_slot, shapes)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{what}: two launches differ")
        cpu = REF.fused_scatter_ref(gout.cpu(), rows.cpu(), slot_t.cpu(),
                                    shapes)
        check(all(torch.equal(a.cpu(), b) for a, b in zip(got, cpu)),
              f"{what}: not bitwise the CPU's sequential (b, s) sum")
        with deterministic(torch):
            want = REF.fused_scatter_ref(gout, rows, slot_t, shapes, col_slot)
        worst = max(worst, scatter_bitwise(torch, got, want, what))
    return worst


def dedup_scatter_phase(torch, coll, plan, feats, grads, ES, DD, REF, ops):
    """The scatter of deduplicated ids at full width: per table, its batch
    ids deduplicated (``dedup_ids``), then ``ops.embedding_scatter(
    grad_t[uniq.clamp_min(0)], uniq, V_t)`` (counted) must equal the
    table's slice ``grad_t`` of the fused scatter's gradient bitwise (rows
    the batch does not name are zero in both); the 150 calls timed whole,
    fill and kernel apart, beside the plain version, the byte bound and
    ``index_copy_``."""
    dev = grads[0].device
    gidx = {k: i for i, k in enumerate(plan.keys)}
    items = []                    # (src (N, D), uniq (N,), V, grad_t, num)
    for _, g in sorted(coll.local_groups.items()):
        for s in g.slots:
            grad_t = grads[gidx[g.name]][s.offset:s.offset + s.rows]
            uniq, _, num = DD.dedup_ids(feats[s.spec.name].reshape(-1))
            items.append((grad_t[uniq.clamp_min(0).long()], uniq, s.rows,
                          grad_t, int(num)))
    with torch.no_grad():
        ES.launches = 0
        outs = [ops.embedding_scatter(src, uniq, V)
                for src, uniq, V, _, _ in items]
        torch.cuda.synchronize()
        launches = ES.launches
        check(launches == len(items), f"embedding scatter: {launches} "
                                      f"launches for {len(items)} tables")
        err = 0.0
        for out, (_, _, _, grad_t, _) in zip(outs, items):
            check(torch.equal(out, grad_t), "embedding scatter: not bitwise "
                                            "the table's fused-scatter "
                                            "gradient")
            err = max(err, (out - grad_t).abs().max().item())
        del outs

        def whole(i):
            for src, uniq, V, _, _ in items:
                ES.embedding_scatter(src, uniq, V)

        def fill(i):
            for src, _, V, _, _ in items:
                torch.zeros((V, src.shape[1]), device=dev)

        def plain(i):
            for src, uniq, V, _, _ in items:
                REF.embedding_scatter_ref(src, uniq, V)

        ms = cuda_ms(torch, whole, 1, iters=5, warmup=1)
        fill_ms = cuda_ms(torch, fill, 1, iters=5, warmup=1)
        plain_ms = cuda_ms(torch, plain, 1, iters=3, warmup=1)
        bufs = [torch.zeros((V, src.shape[1]), device=dev)
                for src, _, V, _, _ in items]
        kernel_ms = cuda_ms(torch, lambda i: [
            ES.scatter_rows(b, src, uniq)
            for b, (src, uniq, _, _, _) in zip(bufs, items)], 1, iters=10)
        del bufs
        copies = [(V, src[:n], uniq[:n].long())
                  for src, uniq, V, _, n in items]

        def library(i):           # zero fill + index_copy_ of the unique rows
            for V, rows, idx in copies:
                torch.zeros((V, rows.shape[1]), device=dev).index_copy_(
                    0, idx, rows)

        library_ms = cuda_ms(torch, library, 1, iters=5, warmup=1)
        del copies
    # bytes: the (V, D) output written once, every id read once, the
    # gradient rows of the valid ids read once; operations: one add a lane
    n_ids = sum(uniq.numel() for _, uniq, _, _, _ in items)
    n_uniq = sum(n for *_, n in items)
    nbytes = sum(V * src.shape[1] * 4 + uniq.numel() * 4
                 + n * src.shape[1] * 4 for src, uniq, V, _, n in items)
    adds = sum(n * src.shape[1] for src, _, _, _, n in items)
    bound_ms, bound_by = bound(nbytes, adds, F32_FLOPS_PER_S)
    del items
    return dict(name="embedding_scatter", route="cuda",
                source="src/repro_torch/kernels/csrc/embedding_scatter.cu",
                replaces="src/repro/kernels/embedding_grad.py:35",
                launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library_ms,
                kernel_ms=kernel_ms, fill_ms=fill_ms, ids=n_ids, unique_ids=n_uniq,
                dedup_ratio=1.0 - n_uniq / max(n_ids, 1), bytes=nbytes)


def descriptor_rows(torch, rows, slots, col_slot, shapes):
    """(B, S) int64: each descriptor's row, numbered across the row spaces
    in order, -1 where it adds nothing (id < 0, id >= R_g, a column no
    slot spans); and a function from such a row to its row space's dim."""
    cs = col_slot.long()
    g = torch.where(cs >= 0, slots[:, 0].long()[cs.clamp_min(0)], -1)
    nrows = torch.tensor([r for r, _ in shapes], device=rows.device)
    dims = torch.tensor([d for _, d in shapes], device=rows.device)
    first = torch.cumsum(nrows, 0) - nrows
    gg = g.clamp_min(0)
    r = rows.long()
    valid = (g >= 0)[None, :] & (r >= 0) & (r < nrows[gg][None, :])
    gid = torch.where(valid, first[gg][None, :] + r, -1)

    def row_dim(x):
        return dims[torch.searchsorted(first, x, right=True) - 1]

    return gid, row_dim


def scatter_kernel_phase(torch, cfg, coll, Dataset, ShapeConfig, FS, REF, B,
                         dedup=None, dev="cuda"):
    """The fused scatter at the training tables' shapes and a batch of B
    from ``Dataset``: bitwise its plain version under deterministic
    algorithms and across two launches, timed whole and by part beside its
    byte bound and ``index_add_``.  ``dedup`` (ES, DD, ops) also runs the
    scatter of deduplicated ids on its gradient (`dedup_scatter_phase`)."""
    shape = ShapeConfig("dlrm_train", "train", 1, B)
    t0 = time.perf_counter()
    batch = Dataset(cfg, shape, seed=0).batch(0)
    data_s = time.perf_counter() - t0
    feats = {t.name: torch.as_tensor(batch[f"cat_{t.name}"], device=dev)
             for t in cfg.dlrm.tables}
    del batch
    meta = {g.name: torch.empty((g.total_rows, d), device="meta")
            for d, g in coll.local_groups.items()}
    plan, groups, rows, slots = coll.fused_inputs(meta, feats)
    col_slot = plan.on(rows.device)[2]
    shapes = [tuple(g.shape) for g in groups]
    K, dmax = len(plan.fslots), plan.dmax
    gen = torch.Generator(device=dev).manual_seed(4)
    gout = torch.randn((B, K, dmax), generator=gen, device=dev)
    what = f"fused scatter at B={B}"

    def plain(i=0):
        return REF.fused_scatter_ref(gout, rows, slots, shapes, col_slot)

    with torch.no_grad():
        got = FS.fused_scatter(gout, rows, slots, col_slot, shapes)
        again = FS.fused_scatter(gout, rows, slots, col_slot, shapes)
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"{what}: two launches differ")
        del again
        with deterministic(torch):
            want = plain()
        err = scatter_bitwise(torch, got, want, what)
        del want
        dd = None
        if dedup is not None:
            dd = dedup_scatter_phase(torch, coll, plan, feats, got, *dedup[:2],
                                     REF, dedup[2])
        del got, feats
        ms = cuda_ms(torch, lambda i: FS.fused_scatter(
            gout, rows, slots, col_slot, shapes), 1, iters=10)
        order_ms = cuda_ms(torch, lambda i: FS.order_descriptors(
            rows, slots, col_slot, shapes), 1, iters=10)
        keys, order = FS.order_descriptors(rows, slots, col_slot, shapes)
        key_bits = keys.element_size() * 8
        grads = [torch.zeros(s, device=dev) for s in shapes]
        kernel_ms = cuda_ms(torch, lambda i: FS.reduce_runs(
            grads, gout, col_slot, keys, order), 1, iters=10)
        fill_ms = cuda_ms(torch, lambda i: [torch.zeros(s, device=dev)
                                            for s in shapes], 1, iters=10)
        plain_ms = cuda_ms(torch, plain, 1, iters=3, warmup=1)
        with deterministic(torch):
            plain_det_ms = cuda_ms(torch, plain, 1, iters=3, warmup=1)
        # the kernel half's two launches apart
        short_ms = cuda_ms(torch, lambda i: FS.reduce_short_runs(
            grads, gout, col_slot, keys, order), 1, iters=10)
        hot = FS.reduce_short_runs(grads, gout, col_slot, keys, order)
        hot_ms = cuda_ms(torch, lambda i: FS.reduce_hot_runs(
            grads, gout, col_slot, keys, order, hot), 1, iters=10)
        items = FS.hot_items(hot)
        hot_runs, hot_items = items[:, 0].unique().numel(), items.shape[0]
        del hot, items
        del keys, order
        # what this batch needs: valid descriptors, distinct rows, runs;
        # from the descriptors, whatever the wrapper's key encoding
        gid, row_dim = descriptor_rows(torch, rows, slots, col_slot, shapes)
        valid = gid[gid >= 0]
        n_valid = valid.numel()
        runs, counts = torch.unique(valid, return_counts=True)
        valid_elems = int(row_dim(valid).sum())
        distinct_elems = int(row_dim(runs).sum())
        n_distinct = runs.numel()
        longest = int(counts.max())
        # the longest run alone: every other descriptor invalid
        hot_rows = torch.where(gid == runs[counts.argmax()], rows, -1)
        del valid, runs, counts, gid
        hot_in = FS.order_descriptors(hot_rows.int(), slots, col_slot, shapes)
        hot_run_ms = cuda_ms(torch, lambda i: FS.reduce_runs(
            grads, gout, col_slot, *hot_in), 1, iters=5)
        del hot_rows, hot_in, grads
        # index_add_, one call a row space, on the gathered slot gradients
        # (gathered beforehand, outside the timing)
        S = rows.shape[1]
        cs = col_slot.long()
        col_group = slots[:, 0].long()[cs]
        b_idx = torch.arange(B, device=dev)[:, None].expand(B, S)
        adds = []
        for g, (R, D) in enumerate(shapes):
            take = (col_group == g)[None, :] & (rows >= 0)
            adds.append((rows[take].long(),
                         gout[b_idx[take], cs.expand(B, S)[take], :D]))
            del take

        def library(i):
            for (R, D), (idx, src) in zip(shapes, adds):
                torch.zeros((R, D), device=dev).index_add_(0, idx, src)

        library_ms = cuda_ms(torch, library, 1, iters=5, warmup=1)
        del adds, b_idx
    lanes = B * sum(s.dim for s in plan.fslots) * 4      # gout lanes < D_k
    grad_bytes = sum(R * D * 4 for R, D in shapes)
    nbytes = grad_bytes + lanes + rows.numel() * 4 + K * 16
    bound_ms, bound_by = bound(nbytes, valid_elems, F32_FLOPS_PER_S)
    touched_ms = (distinct_elems * 4 + lanes + rows.numel() * 4) \
        / HBM_BYTES_PER_S * 1e3
    return dict(name="fused_scatter", route="cuda",
                source="src/repro_torch/kernels/csrc/fused_scatter.cu",
                replaces="src/repro/kernels/embedding_grad.py:74",
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound_by, library_ms=library_ms, batch=B,
                plain_deterministic_ms=plain_det_ms,
                order_ms=order_ms, kernel_ms=kernel_ms, fill_ms=fill_ms,
                key_bits=key_bits, short_ms=short_ms, hot_ms=hot_ms,
                hot_runs=hot_runs, hot_items=hot_items,
                hot_run_min=FS.HOT_RUN, hot_run_ms=hot_run_ms,
                longest_run=longest,
                valid_descriptors=n_valid, distinct_rows=n_distinct,
                touched_bound_ms=touched_ms, gout_read_gb=valid_elems * 4 / 1e9,
                bytes=nbytes, gradient_gb=grad_bytes / 1e9,
                dataset_batch_s=data_s), dd


def dlrm_train_reference_phase(torch, registry, api, ShapeConfig,
                               ParallelConfig, OptimizerConfig, STEPS, OPT,
                               FS, EG, dev="cuda"):
    """Reduced dlrm0, same weights and batch: one step's gradients on the
    CPU (plain versions) and on the card (kernels), through both lookup
    routes, the per-table one also against the fused one; then Adam on the
    same gradients."""
    cfg = registry.get_reduced("dlrm0")
    p_cpu = api.init_params(cfg, seed=0, device="cpu")
    b_cpu = api.make_batch(cfg, ShapeConfig("dlrm_check", "train", 1, 64),
                           seed=1, device="cpu")
    p_gpu, b_gpu = _to(p_cpu, dev), _to(b_cpu, dev)
    pcfg = ParallelConfig(remat="none")
    s0 = FS.launches
    _, g_cpu = STEPS.value_and_grad(cfg, pcfg, p_cpu, b_cpu)
    _, g_gpu = STEPS.value_and_grad(cfg, pcfg, p_gpu, b_gpu)
    torch.cuda.synchronize()
    check(FS.launches == s0 + 1,
          "dlrm training reference: the card's backward did not reach the "
          "fused-scatter kernel")
    worst = (0.0, 0.0, 0.0)                 # (err / tol, err, tol)
    for i, (a, b) in enumerate(zip(g_gpu, g_cpu)):
        check(bool(torch.isfinite(a).all()), f"gradient leaf {i} not finite")
        tol = LOGIT_REL_TOL * b.abs().max().item()
        err = (a.cpu() - b).abs().max().item()
        check(err <= tol, f"dlrm training reference: gradient leaf {i} "
                          f"differs by {err:.4g} > {tol:.4g}")
        worst = max(worst, (err / tol if tol else 0.0, err, tol))
    # the per-table route (ops.GatherRows): one gather a table forward, one
    # fused scatter a row space backward
    per_table = ParallelConfig(remat="none", emb_pipeline=False)
    g0, s0 = EG.launches, FS.launches
    _, gp_cpu = STEPS.value_and_grad(cfg, per_table, p_cpu, b_cpu)
    _, gp_gpu = STEPS.value_and_grad(cfg, per_table, p_gpu, b_gpu)
    torch.cuda.synchronize()
    check((EG.launches - g0, FS.launches - s0)
          == (len(cfg.dlrm.tables), len(p_cpu["tables"])),
          "dlrm training reference: the per-table route did not run one "
          "gather a table and one fused scatter a row space")
    for i, (a, b, f) in enumerate(zip(gp_gpu, gp_cpu, g_gpu)):
        check(bool(torch.isfinite(a).all()), f"per-table gradient leaf {i} "
                                             f"not finite")
        tol = LOGIT_REL_TOL * b.abs().max().item()
        err = (a.cpu() - b).abs().max().item()
        err_f = (a - f).abs().max().item()
        check(err <= tol and err_f <= tol,
              f"dlrm training reference: per-table gradient leaf {i} differs "
              f"from the CPU's by {err:.4g}, from the fused route's by "
              f"{err_f:.4g} (tolerance {tol:.4g})")
        worst = max(worst, (max(err, err_f) / tol if tol else 0.0,
                            max(err, err_f), tol))
    ocfg = OptimizerConfig(lr=1e-2, warmup_steps=1)
    with torch.no_grad():
        p_same = _to(p_gpu, "cpu")
        g_same = [g.cpu() for g in g_gpu]
    p1, s1, _ = OPT.apply(ocfg, p_gpu, g_gpu, OPT.init(ocfg, p_gpu))
    p2, s2, _ = OPT.apply(ocfg, p_same, g_same, OPT.init(ocfg, p_same))
    adam_err = 0.0
    for x, y in zip(OPT.leaves([p1, s1.mu, s1.nu]),
                    OPT.leaves([p2, s2.mu, s2.nu])):
        err = (x.detach().cpu() - y.detach()).abs()
        lim = ADAM_RTOL * (y.detach().abs() + y.detach().abs().max())
        check(bool((err <= lim).all()), f"dlrm training reference: Adam "
                                        f"differs by {err.max().item():.3e}")
        adam_err = max(adam_err, err.max().item())
    return worst, adam_err


def train_phase(torch, cfg, ShapeConfig, RunConfig, ParallelConfig,
                OptimizerConfig, Trainer, STEPS, OPT, FL, FS, dev="cuda",
                batch=TRAIN_BATCH, warm=TRAIN_WARM, timed=TRAIN_TIMED):
    """``Trainer.train`` on the one-card training cut, as a user runs it:
    each step draws its batch from the trainer's ``Dataset`` on the host,
    moves it to the card and steps.  The ``Dataset.batch`` calls are timed
    apart; counters are zeroed just before the run and read just after."""
    run = RunConfig(model=cfg, shape=ShapeConfig("dlrm_train", "train", 1,
                                                 batch),
                    parallel=ParallelConfig(remat="none"),
                    optimizer=OptimizerConfig(lr=3e-4, warmup_steps=20))
    trainer = Trainer(run, device=dev)
    n = warm + timed
    calls, drawn = [], []

    class TimedDataset:             # the trainer's Dataset, calls timed
        def __init__(self, ds):
            self.ds = ds

        def batch(self, step):
            t0 = time.perf_counter()
            drawn.append(self.ds.batch(step))
            calls.append(time.perf_counter() - t0)
            return drawn[-1]

    trainer.dataset = TimedDataset(trainer.dataset)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = trainer.init_state()
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    first = sorted(state.params["tables"])[0]
    before = [state.params["tables"][first][:4096].clone(),
              state.params["top"][0]["w"][:64].clone()]
    marks = []

    def on_step(step, _):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    FL.launches = FS.launches = FS.launches_hot = FS.launches_keys = 0
    t_start = time.perf_counter()
    state = trainer.train(n, state=state, log_every=1, on_step=on_step)
    launches = {"fused_lookup": FL.launches, "fused_scatter": FS.launches,
                "fused_scatter_hot": FS.launches_hot,
                "fused_scatter_keys": FS.launches_keys}
    peak = torch.cuda.max_memory_allocated()
    step_s = [b - a for a, b in zip([t_start] + marks[:-1], marks)]
    losses = [m["loss"] for m in trainer.metrics_log]
    check(all(v == n for v in launches.values()),
          f"training: {launches} launches for {n} steps (one fused lookup "
          f"and one fused scatter, with its key and hot-run kernels, a "
          f"step)")
    check(len(losses) == n and all(math.isfinite(x) for x in losses),
          f"training: losses {losses}")
    data_s = list(calls)            # the profiled steps below draw more
    check(len(data_s) == n, f"training: {len(data_s)} Dataset.batch calls "
                            f"for {n} steps")
    after = [state.params["tables"][first][:4096],
             state.params["top"][0]["w"][:64]]
    check(all(bool(torch.isfinite(a).all()) and not torch.equal(a, b)
              for a, b in zip(after, before)),
          "training: the params did not move (or are not finite)")
    check(peak < TRAIN_PEAK_LIMIT, f"training: peak allocated "
                                   f"{peak / 1e9:.2f} GB >= "
                                   f"{TRAIN_PEAK_LIMIT / 1e9:.0f} GB")
    timed_s = step_s[warm:]
    # the same batches staged on the card first: the train step alone
    staged = [{k: torch.as_tensor(v, device=dev) for k, v in h.items()}
              for h in drawn[:n]]
    del drawn[:]
    torch.cuda.synchronize()
    card_s = []
    for b in staged:
        t0 = time.perf_counter()
        trainer.train_step(state.params, state.opt_state, b)
        torch.cuda.synchronize()
        card_s.append(time.perf_counter() - t0)
    card_s = card_s[warm:]
    # one more step, split into forward + backward and Adam
    b = staged[0]
    del staged[1:]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, grads = STEPS.value_and_grad(cfg, run.parallel, state.params, b)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    _, opt, _ = OPT.apply(run.optimizer, state.params, grads,
                          state.opt_state)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    del grads
    state = type(state)(state.params, opt, state.step + 1)

    def user_step():                # Trainer.train: host data included
        nonlocal state
        state = trainer.train(state.step + 1, state=state, log_every=1)

    def card_step():                # the train step on a batch on the card
        trainer.train_step(state.params, state.opt_state, b)

    prof_user = profile_busy(torch, user_step, top=12)
    prof_card = profile_busy(torch, card_step, top=12)
    med = sorted(timed_s)[len(timed_s) // 2]
    med_card = sorted(card_s)[len(card_s) // 2]
    return {"batch": batch, "steps_warm": warm, "steps_timed": timed,
            "ms_per_step": [t * 1e3 for t in step_s],
            "dataset_batch_s": data_s,
            "median_ms_per_step": med * 1e3,
            "samples_per_s": batch * len(timed_s) / sum(timed_s),
            "ms_per_step_staged": [t * 1e3 for t in card_s],
            "median_ms_per_step_staged": med_card * 1e3,
            "samples_per_s_staged": batch * len(card_s) / sum(card_s),
            "losses": losses, "peak_mem_gb": peak / 1e9, "init_s": init_s,
            "fwd_bwd_ms": (t1 - t0) * 1e3, "adam_ms": (t2 - t1) * 1e3,
            "profile_user_step": prof_user,
            "profile_step_on_card": prof_card}, launches


def per_table_train_phase(torch, cfg, ShapeConfig, RunConfig,
                          ParallelConfig, OptimizerConfig, Trainer, FL, EG,
                          FS, dev="cuda", batch=PER_TABLE_TRAIN_BATCH,
                          steps=2):
    """``Trainer.train`` with ``ParallelConfig(emb_pipeline=False)`` on the
    one-card training cut: the per-table route trains on the card.
    Counters zeroed just before and read just after: one gather a table
    and one fused scatter a row space a step, no fused lookup."""
    run = RunConfig(model=cfg, shape=ShapeConfig("dlrm_train", "train", 1,
                                                 batch),
                    parallel=ParallelConfig(remat="none",
                                            emb_pipeline=False),
                    optimizer=OptimizerConfig(lr=3e-4, warmup_steps=20))
    trainer = Trainer(run, device=dev)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    state = trainer.init_state()
    first = sorted(state.params["tables"])[0]
    before = [state.params["tables"][first][:4096].clone(),
              state.params["top"][0]["w"][:64].clone()]
    n_spaces = len(state.params["tables"])
    marks = []

    def on_step(step, _):
        torch.cuda.synchronize()
        marks.append(time.perf_counter())

    FL.launches = EG.launches = FS.launches = FS.launches_hot = 0
    FS.launches_keys = 0
    t0 = time.perf_counter()
    state = trainer.train(steps, state=state, log_every=1, on_step=on_step)
    launches = {"fused_lookup": FL.launches, "embedding_gather": EG.launches,
                "fused_scatter": FS.launches,
                "fused_scatter_hot": FS.launches_hot,
                "fused_scatter_keys": FS.launches_keys}
    peak = torch.cuda.max_memory_allocated()
    losses = [m["loss"] for m in trainer.metrics_log]
    want = {"fused_lookup": 0,
            "embedding_gather": steps * len(cfg.dlrm.tables),
            "fused_scatter": steps * n_spaces,
            "fused_scatter_hot": steps * n_spaces,
            "fused_scatter_keys": steps * n_spaces}
    check(launches == want, f"per-table training: launches {launches}, "
                            f"want {want}")
    check(len(losses) == steps and all(math.isfinite(x) for x in losses),
          f"per-table training: losses {losses}")
    after = [state.params["tables"][first][:4096],
             state.params["top"][0]["w"][:64]]
    check(all(bool(torch.isfinite(a).all()) and not torch.equal(a, b)
              for a, b in zip(after, before)),
          "per-table training: the params did not move (or are not finite)")
    check(peak < TRAIN_PEAK_LIMIT, f"per-table training: peak allocated "
                                   f"{peak / 1e9:.2f} GB >= "
                                   f"{TRAIN_PEAK_LIMIT / 1e9:.0f} GB")
    return {"batch": batch, "steps": steps, "losses": losses,
            "ms_per_step": [(b - a) * 1e3
                            for a, b in zip([t0] + marks[:-1], marks)],
            "peak_mem_gb": peak / 1e9, "launches": launches}


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
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
    from repro_torch.configs.base import (OptimizerConfig, ParallelConfig,
                                          RunConfig, ShapeConfig)
    from repro_torch.data.synthetic import Dataset
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.embeddings import dedup as DD
    from repro_torch.kernels import embedding_gather as EG
    from repro_torch.kernels import embedding_lookup as EL
    from repro_torch.kernels import embedding_scatter as ES
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import fused_lookup as FL
    from repro_torch.kernels import fused_scatter as FS
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as REF
    from repro_torch.launch import steps as STEPS
    from repro_torch.models import api
    from repro_torch.models import dlrm as DL
    from repro_torch.models import quant as QU
    from repro_torch.models import transformer as TF
    from repro_torch.optim import adam as OPT
    from repro_torch.serve import engine as engine_mod
    from repro_torch.train.trainer import Trainer

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
    pooled = pooled_kernel_phase(torch, np, F, DA, REF, QU, ops)
    for n in ("bt", "q8", "bt_q8"):
        log(f"{pooled[n]['name']} kernel:", json.dumps(pooled[n]))
    log("pooled decode yardstick:", json.dumps(pooled["yardstick"]))
    gc.collect()
    torch.cuda.empty_cache()
    prefill = prefill_phase(torch, F, FA, REF)
    log("prefill kernel:", json.dumps(prefill))
    worst = reference_phase(torch, registry, api, TF)
    log(f"reference: card vs CPU logits differ by at most {worst[1]:.3e} "
        f"(tolerance {worst[2]:.3e} at that step)")
    stats, launches = serve_phase(torch, np, registry.get_config("olmo-1b"),
                                  api, engine_mod, DA, FA)
    log("serve:", json.dumps(stats))
    gc.collect()                    # the serve phase's weights and caches
    torch.cuda.empty_cache()
    pool_stats, pool_launches = pooled_decode_phase(
        torch, np, registry.get_config("olmo-1b"), api, TF, DA)
    log("pooled decode:", json.dumps(pool_stats))
    gc.collect()                    # its weights and pools
    torch.cuda.empty_cache()
    kv_engine, kv_launches = pooled_engine_phase(
        torch, np, registry.get_config("olmo-1b"), api, engine_mod, DA, FA)
    log("pooled engine:", json.dumps(kv_engine))
    gc.collect()
    torch.cuda.empty_cache()
    int8_engine, int8_launches = int8_engine_phase(
        torch, np, registry.get_config("olmo-1b"), api, engine_mod, QU, DA,
        FA)
    log("int8 engine:", json.dumps(int8_engine))
    gc.collect()
    torch.cuda.empty_cache()

    dlrm_kern, dlrm_stats, dlrm_launches, int8 = dlrm_phases(
        torch, F, registry, api, DL, ShapeConfig, FL, EG, EL, ES, QU, REF,
        ops)
    gc.collect()                    # the scoring phase's 48 GB of tables
    torch.cuda.empty_cache()

    grad_worst, adam_err = dlrm_train_reference_phase(
        torch, registry, api, ShapeConfig, ParallelConfig, OptimizerConfig,
        STEPS, OPT, FS, EG)
    log(f"dlrm training reference: card vs CPU gradients (both routes) and "
        f"per-table vs fused differ by at most {grad_worst[1]:.3e} "
        f"(tolerance {grad_worst[2]:.3e} at that leaf); Adam on the same "
        f"gradients by {adam_err:.3e}")
    log(f"fused scatter, small cases: max |kernel - plain| "
        f"{scatter_small_cases(torch, FS, REF):.3e}; bitwise the CPU's "
        f"sequential sum; two launches bitwise equal")
    tcfg = dlrm0_cut(registry, TRAIN_TABLE_PARAMS)
    tcoll = DL.collection_for(tcfg)
    scatter = {}
    for B in (DLRM_CHIP_BATCH, TRAIN_BATCH):
        scatter[B], dedup = scatter_kernel_phase(
            torch, tcfg, tcoll, Dataset, ShapeConfig, FS, REF, B,
            dedup=(ES, DD, ops) if B == TRAIN_BATCH else None)
        log(f"fused scatter at B={B}:", json.dumps(scatter[B]))
        gc.collect()
        torch.cuda.empty_cache()
    log(f"scatter of deduplicated ids at B={TRAIN_BATCH}:", json.dumps(dedup))
    train_stats, train_launches = train_phase(
        torch, tcfg, ShapeConfig, RunConfig, ParallelConfig, OptimizerConfig,
        Trainer, STEPS, OPT, FL, FS)
    train_stats["emb_params"] = sum(t.vocab_size * t.dim
                                    for t in tcfg.dlrm.tables)
    train_stats["launches"] = train_launches
    log("dlrm training:", json.dumps(train_stats))
    gc.collect()                    # the trainer's 64 GB of state
    torch.cuda.empty_cache()
    per_table = per_table_train_phase(
        torch, tcfg, ShapeConfig, RunConfig, ParallelConfig, OptimizerConfig,
        Trainer, FL, EG, FS)
    log("dlrm training, per-table route:", json.dumps(per_table))

    decode["launches"] = launches["paged_decode_attention"]
    # the engine paths beside the serve phase's: each counted on its own
    decode["launches_pooled_engine"] = kv_launches["share"][
        "paged_decode_attention"]
    decode["launches_int8_engine"] = int8_launches["paged_decode_attention"]
    pooled["bt"]["launches"] = pool_launches["paged_decode_attention_bt"]
    prefill["launches"] = launches["flash_attention"]
    prefill["launches_int8_engine"] = int8_launches["flash_attention"]
    fused, gather = (dlrm_kern[DLRM_BATCH][n]
                     for n in ("fused_lookup", "embedding_gather"))
    fused["launches"] = dlrm_launches["fused_lookup"]
    gather["launches"] = dlrm_launches["embedding_gather"]
    scat = scatter[TRAIN_BATCH]
    scat["launches"] = train_launches["fused_scatter"]
    # the fused scatter's key and hot-run kernels, one each a run kernel
    scat["launches_hot"] = train_launches["fused_scatter_hot"]
    scat["launches_keys"] = train_launches["fused_scatter_keys"]
    lookup = dict(dlrm_kern[DLRM_BATCH]["embedding_lookup"])
    lookup["launches"] = sum(k["embedding_lookup"]["launches"]
                             for k in dlrm_kern.values())
    qlookup = dict(int8[DLRM_BATCH], launches=int8["launches"])
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    more = ("launches_hot", "launches_keys", "launches_pooled_engine",
            "launches_int8_engine")
    kernels = {"kernels": [{k: kern[k] for k in keys}
                           | {k: kern[k] for k in more if k in kern}
                           for kern in (decode, pooled["q8"], pooled["bt"],
                                        pooled["bt_q8"], prefill, fused,
                                        gather, scat, lookup, dedup,
                                        qlookup)]}
    check(all(k[n] > 0 for k in kernels["kernels"] for n in
              ("launches",) + more if n in k),
          f"a kernel was not launched on its path: {kernels}")
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count()}
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(
            dict(card=card, serve=stats, reference_worst=worst,
                 pooled_kernels=pooled, pooled_decode=pool_stats,
                 pooled_engine=kv_engine, int8_engine=int8_engine,
                 build_s=build.build_seconds, dlrm_scoring=dlrm_stats,
                 dlrm_kernels={str(b): v for b, v in dlrm_kern.items()},
                 dlrm_training=train_stats,
                 train_reference={"grad_worst": grad_worst,
                                  "adam_err": adam_err},
                 fused_scatter={str(b): v for b, v in scatter.items()},
                 dedup_scatter=dedup,
                 int8_lookup={str(b): v for b, v in int8.items()},
                 per_table_training=per_table,
                 **kernels), indent=2))
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
