"""Plain twin of kernel B3 (5-path downward sweeps + WTA) vs the JAX kernel.

``sgm_wta_pallas_dmajor`` runs in interpret mode on CPU; the port's B2 and
B3 twins run on CPU tensors of the same int16 cost volume (the JAX B1
kernel's output). Identical validity, disparity within 1e-5, margin within
rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_kernels import D, _params, cost_i16, jax_b1  # noqa: F401
from video3d_tpu.kernels.sgm import sgm_wta_pallas_dmajor
from video3d_tpu.ops.stereo import SGBMParams as JaxParams
from video3d_tpu_torch.kernels import sgm


@pytest.mark.parametrize("return_margin", [False, True])
def test_b3_wta_twin(cost_i16, return_margin):
    p = _params()
    jp = JaxParams(num_disparities=D)
    want = sgm_wta_pallas_dmajor(jnp.asarray(cost_i16), jp, interpret=True,
                                 return_margin=return_margin)
    cost = torch.from_numpy(cost_i16).permute(0, 1, 3, 2).contiguous()
    acc = sgm.horizontal_sweeps(cost, p)
    got = sgm.vertical_sweeps_wta(cost, acc, p, return_margin=return_margin)
    if return_margin:
        (want, want_m), (got, got_m) = want, got
        np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m),
                                   rtol=1e-6)
    want, got = np.asarray(want), got.numpy()
    np.testing.assert_array_equal(got >= 0, want >= 0)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (got >= 0).mean() > 0.3  # the shifted pair matches
