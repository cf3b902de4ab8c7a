"""Paged decode attention on the H100: wrapper of ``csrc/decode_attention.cu``.

Replaces the Pallas ``repro/kernels/decode_attention.py::
paged_decode_attention_kernel_call`` (body ``_decode_kernel``) on the
serving path: every layer of every decode step calls it once
(``models/transformer.py::decode_step_paged``).

Bound on the H100: bytes.  A slot's valid K/V rows are read once each and
serve G query heads, about 2*G flops per byte.  The kernel runs one block
per (slot, KV head), streams only rows ``< seq_lens[b]`` (and inside the
window) through shared memory, and keeps the online softmax in f32
registers, so the cache needs no padding and rows past a slot's length are
never read.  See the source for what a later PR would add.

`paged_decode_attention` launches the kernel on CUDA tensors and raises on
anything it does not take; ``ops`` sends CPU tensors to the plain version
in ``ref``.  ``launches`` counts successful launches.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import build

SUPPORTED_HEAD_DIMS = (16, 64, 128)
MAX_GD = 1024          # (H / KH) * head_dim one block holds

launches = 0           # kernel launches in this process


def paged_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           seq_lens: torch.Tensor, *,
                           window: Optional[int] = None,
                           softcap: Optional[float] = None,
                           scale: Optional[float] = None) -> torch.Tensor:
    """q (B, H, d) bf16; k, v (B, S, KH, d) bf16; seq_lens (B,) int32 on the
    card (valid rows per slot, the just-written token included; at most S)
    -> (B, H, d) bf16.  Launched on the current stream."""
    global launches
    build.check_tensor("q", q, torch.bfloat16, 3)
    build.check_tensor("k", k, torch.bfloat16, 4)
    build.check_tensor("v", v, torch.bfloat16, 4)
    build.check_tensor("seq_lens", seq_lens, torch.int32, 1, align=4)
    B, H, d = q.shape
    S, KH = k.shape[1], k.shape[2]
    if tuple(k.shape) != (B, S, KH, d) or v.shape != k.shape:
        raise ValueError(f"k, v must be (B, S, KH, d) = {(B, S, KH, d)}, "
                         f"got {tuple(k.shape)}, {tuple(v.shape)}")
    if seq_lens.shape[0] != B:
        raise ValueError(f"seq_lens must be ({B},), got {tuple(seq_lens.shape)}")
    if len({q.device, k.device, v.device, seq_lens.device}) != 1:
        raise ValueError("q, k, v and seq_lens must be on one device")
    if d not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {SUPPORTED_HEAD_DIMS}")
    if H % KH or (H // KH) * d > MAX_GD:
        raise ValueError(f"need H % KH == 0 and (H/KH)*d <= {MAX_GD}; "
                         f"H={H} KH={KH} d={d}")
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = build.library().repro_decode_attention_bf16(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), seq_lens.data_ptr(),
            out.data_ptr(), B, H, KH, S, d,
            -1 if window is None else int(window),
            0.0 if softcap is None else float(softcap),
            d ** -0.5 if scale is None else float(scale), stream)
    build.check(err, "repro_decode_attention_bf16")
    launches += 1
    return out
