"""Serve a small LM with batched requests through the port's cluster serve
session.

    PYTHONPATH=src python -m repro_torch.launch.serve_lm --arch olmo-1b \
        --requests 8 [--device cpu]

The twin of ``examples/serve_lm.py`` through ``repro_torch.cluster``: the
reduced config of ``--arch`` (any arch the port registers), random weights
from the port's seeded init (seed 0), served on a (4, 4, 8) slice with
``SliceSpec(slots, max_len=128, prompt_len=16, chunk)``; ``--requests``
prompts of 4-11 tokens drawn from ``np.random.default_rng(0)`` as the
example draws them.  Prints the run's stats and the first three requests'
tokens.  ``--chunk`` picks the decode steps per host sync; 1 gives the
same greedy tokens.  whisper-small serves on the legacy full-batch path,
one token a host sync, so its stats report ``chunk`` 1.  ``--arch dlrm0``
is refused: a DLRM has no tokens to serve (the example fails on it too).
Runs on the card unless ``--device cpu`` is given.
"""
import argparse

import numpy as np

from repro_torch.cluster import SliceSpec, Supercomputer
from repro_torch.configs import registry
from repro_torch.configs.base import ModelConfig
from repro_torch.models import api


def example_spec(slots: int = 4, chunk: int = 8) -> SliceSpec:
    """The example's serving envelope."""
    return SliceSpec(slots=slots, max_len=128, prompt_len=16, chunk=chunk)


def example_prompts(vocab: int, n: int):
    """The example's ``n`` prompts: 4-11 tokens each, from seed 0."""
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=rng.integers(4, 12))
            for _ in range(n)]


def serve_lm(arch: str, cfg: ModelConfig, params, spec: SliceSpec, *,
             requests: int = 8, new_tokens: int = 16, device="cuda"):
    """Serve `example_prompts` through ``Slice.serve(cfg, params, spec)``
    on a (4, 4, 8) slice of a machine on ``device`` (where ``params``
    lie), print the example's report and return ``(stats, session)``;
    the slice is freed, the session's engine keeps its requests."""
    sc = Supercomputer(device=device)
    with sc.allocate((4, 4, 8)) as sl:
        session = sl.serve(cfg, params, spec)
        for prompt in example_prompts(cfg.vocab_size, requests):
            session.submit(prompt, max_new_tokens=new_tokens)
        stats = session.run()
        print(f"arch={arch} slice={sl.describe()} slots={spec.slots}")
        for k, v in stats.items():
            print(f"  {k}: {v:.3f}" if isinstance(v, float)
                  else f"  {k}: {v}")
        for r in session.engine.queue[:3]:
            print(f"  req{r.rid}: prompt={list(r.prompt)[:6]}... "
                  f"-> {r.out_tokens[:8]}...")
    return stats, session


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b",
                    choices=list(registry.ARCHS))
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = registry.get_reduced(args.arch)
    if cfg.family == "dlrm":
        ap.error(f"--arch {args.arch} is a DLRM scorer, not a language "
                 f"model: it has no tokens to serve")
    params = api.init_params(cfg, seed=0, device=args.device)
    return serve_lm(args.arch, cfg, params,
                    example_spec(args.slots, args.chunk),
                    requests=args.requests, new_tokens=args.new_tokens,
                    device=args.device)


if __name__ == "__main__":
    main()
