#!/usr/bin/env python3
"""Where full-width qwen3-moe-30b-a3b drops (token, expert) pairs at
prefill, layer by layer, on one card.

    python3 scripts/torch_moe_drops.py [--out results.json]

Builds the port's kernels, draws the bf16 weights from seed 0 (as
``chip_smoke.py``'s MoE phase does) and prefills two waves of 8 x 128
tokens through ``api.prefill``: the serve trace's first 8 prompts
left-padded with token 0 to 128, as ``ServeEngine`` pads an admission
wave, and 8 prompts of 128 random ids (no padding).  For each MoE layer
it prints the dropped fraction (capacity factor 1.25: 80 pairs an
expert), the largest number of pairs routed to one expert, and the
experts that got any.
"""
import argparse
import json
import sys
from pathlib import Path


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", help="also write the results as JSON here")
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("torch_moe_drops: no CUDA device", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parents[1]
    sys.path[:0] = [str(root / "src"), str(root)]
    import chip_smoke as C
    from repro_torch.configs import registry
    from repro_torch.kernels import build
    from repro_torch.models import api
    from repro_torch.models import moe as MOE

    build.build(verbose=False)
    build.library()
    cfg = registry.get_config(C.MOE_ARCH)
    params = api.init_params(cfg, seed=0, device="cuda")
    _, prompts = C.serve_trace(np, cfg.vocab_size)
    padded = np.zeros((8, 128), np.int64)
    for i, p in enumerate(prompts[:8]):
        padded[i, -len(p):] = p
    unpadded = np.random.default_rng(5).integers(0, cfg.vocab_size, (8, 128))
    topk, dispatch = MOE.router_topk, MOE._dispatch_sorted
    out = {"card": torch.cuda.get_device_name(0)}
    for name, toks in (("padded", padded), ("unpadded", unpadded)):
        layers = []

        def rec_topk(cfg_, p, x, dtype):
            g, e, a = topk(cfg_, p, x, dtype)
            load = torch.bincount(e.reshape(-1),
                                  minlength=cfg_.moe.num_experts)
            layers.append(dict(max_load=int(load.max()),
                               experts_used=int((load > 0).sum())))
            return g, e, a

        def rec_dispatch(x, gates, eidx, num_experts, capacity):
            buf, combine, dropped = dispatch(x, gates, eidx, num_experts,
                                             capacity)
            layers[-1].update(capacity=capacity, dropped=float(dropped))
            return buf, combine, dropped

        MOE.router_topk, MOE._dispatch_sorted = rec_topk, rec_dispatch
        try:
            with torch.inference_mode():
                api.prefill(cfg, params,
                            {"tokens": torch.as_tensor(toks, device="cuda")})
        finally:
            MOE.router_topk, MOE._dispatch_sorted = topk, dispatch
        out[name] = dict(pad_tokens=int((toks == 0).sum()), layers=layers)
        print(name, "pads", out[name]["pad_tokens"])
        for key in ("dropped", "max_load", "experts_used"):
            print(f"  {key} by layer",
                  [round(l[key], 3) if key == "dropped" else l[key]
                   for l in layers])
    if args.out:
        Path(args.out).write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
