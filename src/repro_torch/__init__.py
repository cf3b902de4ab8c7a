"""repro_torch — the PyTorch/CUDA port of the `repro` stack.

The port sits beside the JAX package under the same ``PYTHONPATH=src`` and
imports nothing of it (nor JAX): the JAX package is the reference its tests
hold it against.  Layout mirrors ``repro`` where a reader wants to find the
counterpart:

  * `repro_torch.configs` — copies of the dense, DLRM and run-level config
                            dataclasses and an arch registry (olmo-1b, dlrm0)
  * `repro_torch.data`    — the synthetic, seekable `Dataset`
  * `repro_torch.embeddings` — the single-device embedding engine (fused
                            and per-table lookups) and its placement plan
  * `repro_torch.kernels` — hand-written CUDA kernels for sm_90a, their
                            plain PyTorch versions, and device dispatch
  * `repro_torch.models`  — dense transformer layers, prefill/decode, the
                            DLRM forward, `api`
  * `repro_torch.serve`   — continuous-batching `ServeEngine` + `SliceSpec`
  * `repro_torch.optim`   — Adam / AdamW, in place
  * `repro_torch.train`   — the DLRM `Trainer`
  * `repro_torch.launch`  — the train step and the ``python -m
                            repro_torch.launch.serve`` / ``.train`` CLIs
  * `repro_torch.interop` — JAX param trees (as numpy) -> torch tensors

Subpackages import lazily (module ``__getattr__``), as in ``repro``.
"""
import importlib

__all__ = ["configs", "data", "embeddings", "interop", "kernels", "launch",
           "models", "optim", "serve", "train"]


def __getattr__(name):
    if name in __all__:
        return importlib.import_module(f"repro_torch.{name}")
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
