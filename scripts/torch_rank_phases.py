#!/usr/bin/env python3
"""Run the over-ranks phases of ``chip_smoke.py`` alone, on the cards of
one host.

    python3 scripts/torch_rank_phases.py [--layers N] [--out FILE] 24 23

``24``: phase 24, data-parallel olmo-1b on 4 ranks (`dp_phase`; ``--layers``
sets olmo-1b's depth, 2 by default as in the whole script, 16 for the
published model on four cards).  ``23``: phase 23, dlrm0's tables over a
(2, 2) grid (`sharded_dlrm_phase`), after building the kernels it launches.
Each phase spawns ``chip_smoke.py`` once a rank: NCCL with a card a rank
where the host has 4, else gloo on the one card.  Prints the card's name
and power limit, then each phase's summary; writes every result to
``--out`` (default ``results/rank_phases.json``).  Exits non-zero
without a CUDA device or when a phase fails.
"""
import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("phases", nargs="+", choices=["23", "24"])
    ap.add_argument("--layers", type=int, default=None,
                    help="olmo-1b's depth in phase 24")
    ap.add_argument("--out", default="results/rank_phases.json")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("torch_rank_phases: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as CS
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    out = {"card": smi.stdout.strip(), "torch": torch.__version__}
    print(out["card"], flush=True)
    if "23" in args.phases:
        from repro_torch.kernels import build
        t0 = time.perf_counter()
        build.build()
        build.library()
        out["build_s"] = time.perf_counter() - t0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for ph in args.phases:
        if ph == "24":
            r = CS.dp_phase(torch, layers=args.layers or CS.DP_LAYERS)
            out["data_parallel"] = r
            print("phase 24:", json.dumps({k: v for k, v in r.items()
                                           if k != "schemes"}), flush=True)
            for s, v in r["schemes"].items():
                print(f"  {s}:", json.dumps({k: x for k, x in v.items()
                                             if k != "digest"}), flush=True)
        else:
            r, _ = CS.sharded_dlrm_phase(torch)
            out["sharded_dlrm"] = r
            print("phase 23:", json.dumps({k: v for k, v in r.items()
                                           if k != "ranks"}), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
