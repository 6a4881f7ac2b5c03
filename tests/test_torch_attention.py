"""Plain twin of kernel B7 vs the JAX Pallas attention kernels.

The Pallas kernels ``attention_multihead`` and ``attention_oneblock`` run
in interpret mode on CPU; the port's twin ``attention_plain`` and its
wrappers run on CPU tensors. Inputs come from numpy with fixed seeds.
Tolerances: f32 atol 2e-5 (products and sums in another order); bf16
inputs give bf16 outputs, held to 1.5 bf16 ulps of each output
(|err| <= 2^-7 * |want| + 2^-10) -- both round the unnormalised p to bf16
before the PV product, so the difference is one rounding of the output
plus rare one-ulp flips of p. The bf16 kernel's own order of arithmetic
(64-key tiles, k16 steps, two passes) is emulated in plain torch and held
to the card's bf16 gate against the twin. On the card the CUDA kernel is
held against the twin (marked ``cuda``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from video3d_tpu.kernels.attention import (attention_multihead as
                                           jax_multihead,
                                           attention_oneblock as
                                           jax_oneblock)
from video3d_tpu_torch.kernels import attention
from video3d_tpu_torch.ops.attention import attention_plain

# (b, n, s, d, heads_per_step): the shapes of tests/test_dpt.py and one
# DPT-large head shape
SHAPES = [(2, 3, 77, 32, 1), (2, 4, 77, 32, 2), (1, 6, 130, 16, 4),
          (1, 2, 577, 64, 2)]
# on the card also DPT-large's shape and a ragged long sequence
CUDA_SHAPES = SHAPES + [(2, 16, 577, 64, 8), (1, 4, 1500, 32, 4)]


def _qkv(shape, seed):
    r = np.random.default_rng(seed)
    return [r.standard_normal(shape).astype(np.float32) for _ in range(3)]


def _jax(q, k, v, sm, hps, dtype):
    args = [jnp.asarray(a).astype(dtype) for a in (q, k, v)]
    if hps == 1:
        out = jax_oneblock(*args, sm_scale=sm, interpret=True)
    else:
        out = jax_multihead(*args, sm_scale=sm, heads_per_step=hps,
                            interpret=True)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("b,n,s,d,hps", SHAPES)
def test_twin_matches_pallas_f32(b, n, s, d, hps):
    q, k, v = _qkv((b, n, s, d), seed=s + d)
    sm = 1.0 / d ** 0.5
    want = _jax(q, k, v, sm, hps, jnp.float32)
    got = attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                          torch.from_numpy(v), sm)
    assert got.dtype == torch.float32 and got.shape == (b, n, s, d)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("b,n,s,d,hps", SHAPES)
def test_twin_matches_pallas_bf16(b, n, s, d, hps):
    q, k, v = _qkv((b, n, s, d), seed=s + d + 1)
    sm = 1.0 / d ** 0.5
    want = _jax(q, k, v, sm, hps, jnp.bfloat16)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    got = attention_plain(tq, tk, tv, sm)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    assert (err <= 2.0 ** -7 * np.abs(want) + 2.0 ** -10).all(), err.max()


def _bf16_gate(got, want):
    """The smoke's bf16 gate: share of outputs within 2^-7 |want| + 2^-10."""
    err = (got.float() - want).abs()
    return (err <= 2.0 ** -7 * want.abs() + 2.0 ** -10).float().mean().item()


def kernel_order_bf16(q, k, v, sm_scale):
    """The bf16 CUDA kernel's arithmetic, in plain torch on f32 copies of
    the bf16 inputs (exact). Keys come in tiles of 64 (zeros past S,
    masked), shared out between two warpgroups (even and odd tiles). Each
    tile's QK^T is summed over D in k16 steps in f32, then scaled. Pass 1
    takes the exact row max over the real keys, combined over both
    warpgroups. Pass 2 computes p = exp(s - m) (0 past S), adds the
    unrounded p to the warpgroup's z, rounds p to bf16 and adds its product
    with V, in k16 steps of keys, to the warpgroup's f32 output. The block
    adds the second warpgroup's z and output to the first's; out = o / z in
    bf16."""
    b, n, s, d = q.shape
    nk = -(-s // 64)
    qf = q.float()
    kf, vf = (F.pad(t.float(), (0, 0, 0, nk * 64 - s)) for t in (k, v))

    def tile_scores(t):
        kt = kf[:, :, 64 * t:64 * t + 64]
        acc = torch.zeros(b, n, s, 64)
        for d0 in range(0, d, 16):
            acc = acc + qf[..., d0:d0 + 16] @ kt[..., d0:d0 + 16].transpose(
                -1, -2)
        real = torch.arange(64 * t, 64 * t + 64) < s
        return acc * float(sm_scale), real

    m = torch.full((b, n, s, 1), -torch.inf)
    for t in range(nk):
        st, real = tile_scores(t)
        m = torch.maximum(m, st.masked_fill(~real, -torch.inf).amax(
            -1, keepdim=True))
    z = [torch.zeros(b, n, s, 1) for _ in range(2)]
    o = [torch.zeros(b, n, s, d) for _ in range(2)]
    for t in range(nk):
        st, real = tile_scores(t)
        p = torch.where(real, torch.exp(st - m), torch.zeros(()))
        z[t % 2] = z[t % 2] + p.sum(-1, keepdim=True)
        pb = p.to(torch.bfloat16).float()
        for j0 in range(0, 64, 16):
            o[t % 2] = o[t % 2] + pb[..., j0:j0 + 16] @ vf[
                :, :, 64 * t + j0:64 * t + j0 + 16]
    return ((o[0] + o[1]) / (z[0] + z[1])).to(torch.bfloat16)


@pytest.mark.parametrize("shape", [(1, 2, 577, 64), (1, 6, 130, 16),
                                   (1, 4, 1500, 32)])
def test_kernel_order_emulation_within_bf16_gate(shape):
    q, k, v = (torch.from_numpy(a).to(torch.bfloat16)
               for a in _qkv(shape, seed=shape[2] + 7))
    sm = 1.0 / shape[-1] ** 0.5
    got = kernel_order_bf16(q, k, v, sm)
    want = attention_plain(q, k, v, sm).float()
    assert got.dtype == torch.bfloat16 and got.shape == shape
    assert _bf16_gate(got, want) >= 0.999


def test_wrappers_on_cpu_run_the_twin():
    q, k, v = (torch.from_numpy(a) for a in _qkv((2, 4, 77, 32), seed=3))
    sm = 1.0 / 32 ** 0.5
    before = attention.launches
    want = attention_plain(q, k, v, sm)
    assert torch.equal(attention.attention_multihead(q, k, v, sm), want)
    assert torch.equal(attention.attention_multihead(q, k, v, sm, 3), want)
    assert torch.equal(attention.attention_oneblock(q, k, v, sm), want)
    assert attention.launches == before == 0


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel against its twin
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,n,s,d,hps", CUDA_SHAPES)
def test_cuda_kernel_matches_twin(cuda_device, dtype, b, n, s, d, hps):
    q, k, v = (torch.from_numpy(a).to(cuda_device, dtype)
               for a in _qkv((b, n, s, d), seed=5))
    sm = 1.0 / d ** 0.5
    want = attention_plain(q, k, v, sm).float()
    for got in (attention.attention_multihead(q, k, v, sm, hps),
                attention.attention_oneblock(q, k, v, sm)):
        torch.cuda.synchronize()
        err = (got.float() - want).abs()
        if dtype == torch.float32:
            assert err.max().item() <= 1e-5
        else:
            assert _bf16_gate(got, want) >= 0.999
