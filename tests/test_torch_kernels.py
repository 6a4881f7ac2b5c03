"""Plain twins of the port's CUDA kernels B1 and B2 vs the JAX kernels.

The JAX Pallas kernels run in interpret mode on CPU (as
tests/test_sgm_pallas.py runs them); the port's twins run on CPU tensors.
Inputs come from numpy with a fixed seed and go to both; both must agree
bit for bit. B3 and B4 have their own files. The CUDA kernels themselves
are held against their twins on the card (marked ``cuda``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video3d_tpu.kernels.costvol import fused_cost_volume
from video3d_tpu.kernels.sgm import _directional_pass_dmajor
from video3d_tpu_torch.kernels import costvol, sgm, speckle
from video3d_tpu_torch.ops import stereo

B, H, W, D = 2, 16, 64, 16


def _gray_pair(seed, b=B, h=H, w=W, shift=3):
    r = np.random.default_rng(seed)
    base = r.uniform(0, 255, (b, h, w + shift)).astype(np.float32)
    return base[:, :, :w].copy(), base[:, :, shift:shift + w].copy()


def _params(**kw):
    return stereo.SGBMParams(num_disparities=D, **kw)


@pytest.fixture(scope="module")
def jax_b1():
    """B1 outputs of the JAX kernel: int16 (B, H, D, W) cost and the
    int16 (B, H, W) prefiltered left view."""
    left, right = _gray_pair(1)
    p = _params()
    cost, lf = fused_cost_volume(
        jnp.asarray(left), jnp.asarray(right), D, p.block_size,
        out_dtype=jnp.int16, raw_invalid=2.0 * p.prefilter_cap,
        interpret=True, prefilter_cap=p.prefilter_cap,
        return_filtered_left=True)
    return np.asarray(cost), np.asarray(lf)


@pytest.fixture(scope="module")
def cost_i16(jax_b1):
    return jax_b1[0].copy()


def test_b1_cost_volume_twin_bit_exact(jax_b1):
    left, right = _gray_pair(1)
    p = _params()
    cost, lf = costvol.cost_volume(torch.from_numpy(left),
                                   torch.from_numpy(right), p,
                                   2.0 * p.prefilter_cap,
                                   return_filtered_left=True)
    assert cost.dtype == torch.int16 and cost.shape == (B, H, W, D)
    np.testing.assert_array_equal(cost.permute(0, 1, 3, 2).numpy(),
                                  jax_b1[0])
    assert lf.dtype == torch.int16
    np.testing.assert_array_equal(lf.numpy(), jax_b1[1])


@pytest.mark.parametrize("shifts", [(0,), (0, 1, -1)])
@pytest.mark.parametrize("reverse", [False, True])
def test_b2_sweep_twin_exact(cost_i16, shifts, reverse):
    p = _params()
    r = np.random.default_rng(2)
    acc = r.integers(0, 5000, cost_i16.shape).astype(np.int16)
    want = _directional_pass_dmajor(jnp.asarray(cost_i16), jnp.asarray(acc),
                                    shifts, p.p1, p.p2, reverse,
                                    interpret=True)
    got = stereo.sgm_sweep_dmajor(torch.from_numpy(cost_i16),
                                  torch.from_numpy(acc), shifts, p.p1, p.p2,
                                  reverse)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_b2_fresh_accumulator_exact(cost_i16):
    p = _params()
    want = _directional_pass_dmajor(jnp.asarray(cost_i16), None, (0,), p.p1,
                                    p.p2, False, interpret=True,
                                    acc_dtype=jnp.int16)
    got = stereo.sgm_sweep_dmajor(torch.from_numpy(cost_i16), None, (0,),
                                  p.p1, p.p2, False, torch.int16)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# On the card: each CUDA kernel against its plain twin
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_cuda_kernels_match_twins(cuda_device):
    left, right = _gray_pair(4, b=2, h=40, w=200)
    p = stereo.SGBMParams(num_disparities=64)
    lg = torch.from_numpy(left).to(cuda_device)
    rg = torch.from_numpy(right).to(cuda_device)
    inv = 2.0 * p.prefilter_cap
    cost, lf = costvol.cost_volume(lg, rg, p, inv, return_filtered_left=True)
    cost_p, lf_p = costvol.cost_volume_plain(lg, rg, p, inv, True)
    assert torch.equal(cost, cost_p) and torch.equal(lf, lf_p)
    acc = sgm.horizontal_sweeps(cost, p)
    assert torch.equal(acc, sgm.horizontal_sweeps_plain(cost, p))
    disp_p, m_p = sgm.vertical_sweeps_wta_plain(cost, acc, p, True)
    disp, m = sgm.vertical_sweeps_wta(cost, acc.clone(), p, True)
    assert torch.equal(disp >= 0, disp_p >= 0)
    assert (disp - disp_p).abs().max().item() <= 1e-5
    assert torch.allclose(m, m_p, rtol=1e-6)
    sp = speckle.speckle_filter(disp, -1.0, 32.0, 100, (0.0, 64.0))
    from video3d_tpu_torch.ops.speckle import speckle_filter_device

    assert torch.equal(sp, speckle_filter_device(disp, -1.0, 32.0, 100))
