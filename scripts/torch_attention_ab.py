#!/usr/bin/env python3
"""Time the PyTorch/CUDA port's kernels of several source trees in turns, on
one card, in one call.

    python3 scripts/torch_attention_ab.py --trees OLD NEW NEW OLD \
        [--phases attention|scatter] [--kernels-only] [--out results.json]

Each tree is a checkout (or a ``git archive``) of this repository.  Every
entry of ``--trees`` runs in a fresh process, in the order given, which
builds and imports that tree's ``src/repro_torch`` and runs THIS tree's
``chip_smoke.py`` phases on it (the phases take the modules they measure
as arguments, and the wrappers, ``api``, the engine and the transformer
keep their signatures across trees):

  * ``decode_phase``: row 1 at B=8, H=KH=16, d=128, S=1024, lengths
    0-1024, kernel and SDPA in turns (kernel, SDPA, SDPA, kernel);
  * ``pooled_kernel_phase``: rows 3, 1q and 3q on a pool of 1024 blocks of
    16 rows, in turns with SDPA on the gathered bf16 view;
  * ``prefill_phase``: row 2 at B=8, H=KH=16, T=S=128, d=128, kernel and
    SDPA in turns;
  * ``serve_phase``: full-width olmo-1b served by ``ServeEngine`` (tokens/s);
  * ``pooled_decode_phase``: 16 pooled decode steps of full-width olmo-1b,
    ms a step three ways, each in three turns.

``--kernels-only`` stops after the prefill phase.

``--phases scatter`` runs instead ``scatter_kernel_phase`` with the
scatter of deduplicated ids (``dedup_scatter_phase``) on dlrm0 cut to 4e9
table parameters at B = 4096 (``Dataset`` ids): the fused scatter (row
5) whole, fill, ordering, run kernel (and its run and hot-run launches
apart, where the tree has them), the longest run alone and
``index_add_``; the 150 calls of the scatter of deduplicated ids (row 8)
whole, fill and kernel, and zero fill + ``index_copy_``.

Each run prints one JSON line (the card's name and power limit as
``nvidia-smi`` gives them, the kernels' ms, bound and SDPA ms, tokens/s,
ms a pooled step); the last line is a summary by tree.  Needs one CUDA card
and ``nvcc``.
"""
import argparse
import importlib.util
import json
import statistics
import subprocess
import sys
import time
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    CS = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(CS)
    return CS


def _card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()


def worker(tree: Path, kernels_only: bool) -> dict:
    sys.path.insert(0, str(tree / "src"))
    import numpy as np
    import torch
    import torch.nn.functional as F
    from repro_torch.configs import registry
    from repro_torch.kernels import build
    from repro_torch.kernels import decode_attention as DA
    from repro_torch.kernels import flash_attention as FA
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as REF
    from repro_torch.models import api
    from repro_torch.models import quant as QU
    from repro_torch.models import transformer as TF
    from repro_torch.serve import engine as engine_mod
    CS = _chip_smoke()
    if not torch.cuda.is_available():
        raise SystemExit("torch_attention_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card()
    assert Path(DA.__file__).is_relative_to(tree), DA.__file__
    t0 = time.perf_counter()
    build.library()
    build_s = time.perf_counter() - t0

    def kern(k):
        keys = ("ms", "bound_ms", "bound_by", "library_ms", "max_abs_err",
                "ms_turns")
        return {n: k[n] for n in keys if n in k}

    out = {"tree": str(tree), "card": card, "build_s": build_s}
    out["row1"] = kern(CS.decode_phase(torch, F, DA, REF))
    pooled = CS.pooled_kernel_phase(torch, np, F, DA, REF, QU, ops)
    for row, n in (("row3", "bt"), ("row1q", "q8"), ("row3q", "bt_q8")):
        out[row] = kern(pooled[n])
    out["pooled_yardstick"] = pooled["yardstick"]
    del pooled
    out["row2"] = kern(CS.prefill_phase(torch, F, FA, REF))
    if kernels_only:
        return out
    cfg = registry.get_config("olmo-1b")
    stats, _ = CS.serve_phase(torch, np, cfg, api, engine_mod, DA, FA)
    out["serve"] = {n: stats[n] for n in ("tokens_per_s", "decode_steps")
                    if n in stats}
    torch.cuda.empty_cache()
    pool, _ = CS.pooled_decode_phase(torch, np, cfg, api, TF, DA)
    out["pooled_decode_ms_a_step"] = {
        n: pool[n] for n in ("step_ms_pooled", "step_ms_gathered_view",
                             "step_ms_decode_n_chunk")}
    return out


ROW5 = ("ms", "fill_ms", "order_ms", "kernel_ms", "short_ms", "hot_ms",
        "hot_run_ms", "library_ms", "bound_ms", "touched_bound_ms",
        "max_abs_err", "key_bits", "hot_runs", "hot_items", "longest_run")
ROW8 = ("ms", "fill_ms", "kernel_ms", "library_ms", "bound_ms",
        "max_abs_err", "launches")


def _one_launch(FS, torch):
    """A tree whose fused scatter sums every run in one launch (no hot-run
    kernel), seen through the two-launch interface that
    ``scatter_kernel_phase`` times: the whole kernel half as the run
    launch, an empty hot list, no hot-run launch.  The split times this
    gives are dropped from its results."""
    def short(grads, gout, col_slot, keys, order):
        FS.reduce_runs(grads, gout, col_slot, keys, order)
        return torch.zeros(2, dtype=torch.int64, device=gout.device)

    return types.SimpleNamespace(
        **{k: v for k, v in vars(FS).items() if not k.startswith("__")},
        reduce_short_runs=short, reduce_hot_runs=lambda *a: None,
        hot_items=lambda hot: hot[2:].view(-1, 3), HOT_RUN=None)


def scatter_worker(tree: Path) -> dict:
    """Rows 5 and 8 of ``tree`` at B = 4096 on the 4e9 training cut."""
    sys.path.insert(0, str(tree / "src"))
    import torch
    from repro_torch.configs import registry
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.synthetic import Dataset
    from repro_torch.embeddings import dedup as DD
    from repro_torch.kernels import build
    from repro_torch.kernels import embedding_scatter as ES
    from repro_torch.kernels import fused_scatter as FS
    from repro_torch.kernels import ops
    from repro_torch.kernels import ref as REF
    from repro_torch.models import dlrm as DL
    CS = _chip_smoke()
    if not torch.cuda.is_available():
        raise SystemExit("torch_attention_ab: no CUDA device")
    assert Path(FS.__file__).is_relative_to(tree), FS.__file__
    out = {"tree": str(tree), "card": _card()}
    t0 = time.perf_counter()
    build.library()
    out["build_s"] = time.perf_counter() - t0
    cfg = CS.dlrm0_cut(registry, CS.TRAIN_TABLE_PARAMS)
    one = not hasattr(FS, "reduce_short_runs")
    fs, es = CS.scatter_kernel_phase(
        torch, cfg, DL.collection_for(cfg), Dataset, ShapeConfig,
        _one_launch(FS, torch) if one else FS, REF, CS.TRAIN_BATCH,
        dedup=(ES, DD, ops))
    split = ("short_ms", "hot_ms", "hot_runs", "hot_items")
    out["row5"] = {k: fs[k] for k in ROW5
                   if k in fs and not (one and k in split)}
    out["row8"] = {k: es[k] for k in ROW8 if k in es}
    return out


def scatter_summary(runs):
    """Per tree: the mean over its runs of each of rows 5 and 8's times,
    and the runs' times as measured."""
    by = {}
    for r in runs:
        by.setdefault(r["tree"], []).append(r)
    table = {}
    for tree, rs in by.items():
        row = {"runs": len(rs), "card": rs[0]["card"]}
        for k, keys in (("row5", ROW5), ("row8", ROW8)):
            for n in keys:
                vals = [r[k][n] for r in rs if r[k].get(n) is not None]
                if n.endswith("ms") and len(vals) == len(rs):
                    row[f"{k}_{n}"] = statistics.mean(vals)
                    row[f"{k}_{n}_runs"] = vals
                elif vals:
                    row[f"{k}_{n}"] = vals[0]
        table[tree] = row
    return table


def summary(runs):
    """Per tree: the mean over its runs of each kernel's ms and SDPA ms,
    tokens/s and the pooled step's ms."""
    by = {}
    for r in runs:
        by.setdefault(r["tree"], []).append(r)
    table = {}
    for tree, rs in by.items():
        row = {"runs": len(rs), "card": rs[0]["card"]}
        for k in ("row1", "row1q", "row2", "row3", "row3q"):
            row[k + "_ms"] = statistics.mean(r[k]["ms"] for r in rs)
            lib = [r[k].get("library_ms") for r in rs]
            if all(x is not None for x in lib):
                row[k + "_sdpa_ms"] = statistics.mean(lib)
            row[k + "_bound_ms"] = rs[0][k]["bound_ms"]
        row["pooled_sdpa_on_view_ms"] = statistics.mean(
            r["pooled_yardstick"]["sdpa_on_gathered_view_ms"] for r in rs)
        if "serve" in rs[0]:
            row["serve_tokens_per_s"] = [r["serve"]["tokens_per_s"]
                                         for r in rs]
            row["pooled_step_ms"] = [
                r["pooled_decode_ms_a_step"]["step_ms_pooled"] for r in rs]
        table[tree] = row
    return table


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--trees", nargs="+", help="source trees, in run order")
    ap.add_argument("--out", help="also write every run as JSON here")
    ap.add_argument("--kernels-only", action="store_true",
                    help="time the kernels only (no serve or pooled decode)")
    ap.add_argument("--phases", choices=("attention", "scatter"),
                    default="attention",
                    help="the attention kernels and serving (default), or "
                         "the two embedding-gradient scatters")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        tree = Path(args.worker).resolve()
        res = (scatter_worker(tree) if args.phases == "scatter"
               else worker(tree, args.kernels_only))
        print(json.dumps(res), flush=True)
        return 0
    runs = []
    for tree in args.trees:
        res = subprocess.run(
            [sys.executable, __file__, "--worker", tree,
             "--phases", args.phases]
            + ["--kernels-only"] * args.kernels_only,
            stdout=subprocess.PIPE, text=True)
        if res.returncode != 0:
            print(res.stdout[-4000:], flush=True)
            raise SystemExit(f"run on {tree} failed ({res.returncode})")
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    table = (scatter_summary if args.phases == "scatter" else summary)(runs)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps({"runs": runs, "summary": table},
                                             indent=2))
    print(json.dumps(table), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
