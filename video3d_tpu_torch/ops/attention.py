"""Plain PyTorch twin of kernel B7 (fused self-attention).

softmax(q k^T * sm_scale) v for (B, N, S, D) heads, in the order of the
TPU kernel's body (``video3d_tpu/kernels/attention.py _multihead_kernel``):
f32 scores, the exact row max over the S keys, unnormalised
p = exp(s - m) rounded to v's dtype before the PV product, the f32 row sum
z of the unrounded p, and the division by z at the end. (The JAX einsum
path normalises before rounding; the kernel and this twin do not.)
"""

from __future__ import annotations

import torch


def attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    sm_scale: float) -> torch.Tensor:
    """(B, N, S, D) q, k, v -> (B, N, S, D) in q's dtype."""
    s = torch.matmul(q.float(), k.float().transpose(-1, -2)) * float(sm_scale)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    z = p.sum(dim=-1, keepdim=True)
    o = torch.matmul(p.to(v.dtype).float(), v.float())
    return (o / z).to(q.dtype)
