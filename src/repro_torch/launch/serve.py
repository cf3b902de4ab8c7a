"""CLI serving driver of the port (serve fast path, one device).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b

serves full-width olmo-1b on the card with random weights from ``--seed``;
``--reduced`` picks the smoke-test config and ``--device cpu`` the CPU
(plain attention instead of the CUDA kernels).  ``--chunk`` sets the decode
tokens advanced per host sync; ``--chunk 1`` gives identical greedy output.
The cluster facade (``Supercomputer``) of ``repro.launch.serve`` is not
ported yet (ROADMAP.md, queue 1, item 8).
"""
import argparse
import json

import numpy as np

from repro_torch.configs import registry
from repro_torch.models import api
from repro_torch.serve.engine import ServeEngine, SliceSpec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=registry.ARCHS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--chunk", type=int, default=8,
                    help="decode steps per host sync (1 = per-token)")
    ap.add_argument("--sample", action="store_true",
                    help="temperature sampling instead of greedy decode")
    ap.add_argument("--reduced", action="store_true",
                    help="the reduced smoke-test config, not full width")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = (registry.get_reduced(args.arch) if args.reduced
           else registry.get_config(args.arch))
    params = api.init_params(cfg, seed=args.seed, device=args.device)
    eng = ServeEngine(cfg, params,
                      SliceSpec(slots=args.slots, max_len=args.max_len,
                                prompt_len=args.prompt_len,
                                greedy=not args.sample, chunk=args.chunk),
                      device=args.device)
    rng = np.random.default_rng(args.seed)
    for _ in range(args.requests):
        eng.submit(rng.integers(0, cfg.vocab_size, size=8),
                   max_new_tokens=args.new_tokens)
    stats = eng.run()
    print(json.dumps(stats, indent=2))
    return stats


if __name__ == "__main__":
    main()
