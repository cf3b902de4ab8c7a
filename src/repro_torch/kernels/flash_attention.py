"""Causal prefill attention on the H100: wrapper of ``csrc/flash_attention.cu``.

Replaces the Pallas ``repro/kernels/flash_attention.py::flash_attention``
(body ``_flash_kernel``).  The JAX prefill computes the same function in
plain jnp (``layers.blocked_attention``); in the port this kernel is the
prefill attention: every layer of every admission wave calls it once
(``models/transformer.py::prefill``).

Bound on the H100: bytes at serving shapes (T = S = 128, d = 128: about 65
causal flops per byte of q, k, v and out).  The kernel runs one block per
(32-row q tile, head, batch), keeps the q tile in shared memory, walks K/V
tiles only up to the causal/window limit, and masks the ragged T and S
edges instead of asserting divisibility, because the engine's T is its
prompt length.  See the source for what a later PR would add.

`flash_attention` launches the kernel on CUDA tensors and raises on
anything it does not take; ``ops`` sends CPU tensors to the plain version
in ``ref``.  ``launches`` counts successful launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build
from repro_torch.kernels.decode_attention import SUPPORTED_HEAD_DIMS

launches = 0           # kernel launches in this process


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None) -> torch.Tensor:
    """q (B, H, T, d) bf16; k, v (B, KH, S, d) bf16, all contiguous on the
    card -> (B, H, T, d) bf16.  Launched on the current stream."""
    global launches
    build.check_tensor("q", q, torch.bfloat16, 4)
    build.check_tensor("k", k, torch.bfloat16, 4)
    build.check_tensor("v", v, torch.bfloat16, 4)
    B, H, T, d = q.shape
    KH, S = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, KH, S, d) or v.shape != k.shape:
        raise ValueError(f"k, v must be (B, KH, S, d) = {(B, KH, S, d)}, "
                         f"got {tuple(k.shape)}, {tuple(v.shape)}")
    if len({q.device, k.device, v.device}) != 1:
        raise ValueError("q, k and v must be on one device")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {SUPPORTED_HEAD_DIMS}")
    if H % KH or B > 65535 or H > 65535 or T == 0:
        raise ValueError(f"need H % KH == 0, B, H <= 65535 and T > 0; "
                         f"B={B} H={H} KH={KH} T={T}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.library().repro_flash_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            B, H, KH, T, S, d, int(causal),
            -1 if window is None else int(window),
            0.0 if softcap is None else float(softcap),
            d ** -0.5 if scale is None else float(scale), stream)
    build.check(err, "repro_flash_attention_bf16")
    launches += 1
    return out
