"""CLI serving driver of the port (serve fast path, one device).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b

serves full-width olmo-1b on the card with random weights from ``--seed``
(``--arch qwen3-moe-30b-a3b`` or ``kimi-k2-1t-a32b``: a MoE model;
full-width kimi-k2 does not fit one card; ``mamba2-130m``: the SSM family;
``hymba-1.5b``: the hybrid one; ``qwen2-7b``, ``mistral-nemo-12b``,
``gemma2-9b``: the dense variants; ``internvl2-2b``: the VLM, each prompt
after 1024 zero patches, whose rows ``--max-len`` counts, as the reference's
CLI does (so it must be at least 1024 + ``--prompt-len``);
``whisper-small``: the encoder-decoder on the legacy full-batch path, over
zero frames, one token a host sync whatever ``--chunk`` says);
``--reduced`` picks the smoke-test config and ``--device cpu`` the CPU
(plain attention instead of the CUDA kernels).  ``--chunk`` sets the decode
tokens advanced per host sync; ``--chunk 1`` gives identical greedy output.
It builds the engine directly, the one ``repro_torch.cluster``'s
``Slice.serve`` builds, where ``repro.launch.serve`` allocates a slice
first.
"""
import argparse
import json

import numpy as np

from repro_torch.configs import registry
from repro_torch.models import api
from repro_torch.models import transformer as TF
from repro_torch.serve.engine import ServeEngine, SliceSpec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b", choices=[
        a for a in registry.ARCHS if registry.get_config(a).family
        in TF.SERVE_FAMILIES + ("audio",)])
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
    if args.max_len < args.prompt_len + cfg.vision_prefix:
        ap.error(f"--max-len {args.max_len} leaves no room for the "
                 f"{cfg.vision_prefix} patch rows and the --prompt-len "
                 f"{args.prompt_len} prompt of {args.arch}")
    params = api.init_params(cfg, seed=args.seed, device=args.device)
    eng = ServeEngine(cfg, params,
                      SliceSpec(slots=args.slots,
                                max_len=args.max_len,
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
