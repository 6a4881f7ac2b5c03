"""Kernel B7 wrappers: fused self-attention (DPT's ViT blocks).

CUDA source: ``video3d_tpu_torch/csrc/attention.cu``, one kernel for both
entry points: :func:`attention_multihead` replaces the TPU kernel
``video3d_tpu/kernels/attention.py attention_multihead`` (B7a) and
:func:`attention_oneblock` replaces ``attention_oneblock`` (B7b). bf16
runs on the tensor cores (wgmma, TMA-fed K/V tiles), f32 on the CUDA
cores. The plain twin is
:func:`video3d_tpu_torch.ops.attention.attention_plain`.
"""

from __future__ import annotations

import torch

from video3d_tpu_torch.kernels import _build
from video3d_tpu_torch.ops.attention import attention_plain

launches = 0  # calls that launched the CUDA kernel (B7a and B7b)

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous at a 16-byte aligned address (TMA reads from it)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            sm_scale: float) -> torch.Tensor:
    global launches
    q, k, v = _aligned(q), _aligned(k), _aligned(v)
    if q.dtype not in _DTYPES:
        raise ValueError(f"attention: f32 or bf16 only, got {q.dtype}")
    for t, name in ((q, "attention q"), (k, "attention k"),
                    (v, "attention v")):
        _build.require(t, q.dtype, 4, name)
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("attention: q, k and v shapes differ")
    b, n, s, d = q.shape
    if d not in (16, 32, 64):
        raise ValueError(f"attention: head dim must be 16, 32 or 64: {d}")
    out = torch.empty_like(q)
    _build.check(_build.lib().v3d_attention(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, n, s, d,
        _DTYPES[q.dtype], float(sm_scale), _build.stream_of(q)),
        "v3d_attention")
    launches += 1
    return out


def attention_multihead(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        sm_scale: float,
                        heads_per_step: int = 8) -> torch.Tensor:
    """softmax(q k^T * sm_scale) v for (B, N, S, D) heads. Any S; D in
    {16, 32, 64}; f32 or bf16.

    ``heads_per_step`` keeps the JAX signature. The TPU kernel halves it
    until it divides N and runs that many heads per grid step, to amortise
    its per-step cost; on the GPU a group of heads would only run one
    after another in a block, so every head gets its own blocks and the
    launch is :func:`attention_oneblock`'s, whatever the value.

    A CUDA tensor runs the kernel, a CPU tensor the plain twin.
    """
    del heads_per_step  # no effect on the GPU (see above)
    if not q.is_cuda:
        return attention_plain(q, k, v, sm_scale)
    return _launch(q, k, v, sm_scale)


def attention_oneblock(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       sm_scale: float) -> torch.Tensor:
    """softmax(q k^T * sm_scale) v for (B, N, S, D) heads, one head per
    block. A CUDA tensor runs the kernel, a CPU tensor the plain twin."""
    if not q.is_cuda:
        return attention_plain(q, k, v, sm_scale)
    return _launch(q, k, v, sm_scale)
