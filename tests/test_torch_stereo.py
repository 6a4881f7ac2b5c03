"""The port's whole matcher vs the JAX TPU path run in interpret mode.

``video3d_tpu_torch.ops.stereo.sgbm_disparity`` on CPU tensors (the plain
twins of B1-B4) against the composition the JAX TPU path runs
(``ops/stereo.py:696-722`` and ``_speckle``): ``fused_cost_volume`` ->
``sgm_wta_pallas_dmajor`` -> ``speckle_filter_pallas``, all with
``interpret=True``. Identical validity, disparity within 1e-5, at a
lane-aligned width and at an unaligned one (the TPU gates those off to
its XLA path; the port takes any width).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video3d_tpu.kernels.costvol import fused_cost_volume
from video3d_tpu.kernels.sgm import sgm_wta_pallas_dmajor
from video3d_tpu.kernels.speckle import speckle_filter_pallas
from video3d_tpu.ops import stereo as jstereo
from video3d_tpu_torch.ops import stereo


def _jax_tpu_path(left, right, p, return_margin):
    res = fused_cost_volume(
        jnp.asarray(left), jnp.asarray(right), p.num_disparities,
        p.block_size, out_dtype=jnp.int16,
        raw_invalid=2.0 * p.prefilter_cap, interpret=True,
        prefilter_cap=p.prefilter_cap, return_filtered_left=return_margin)
    cost, lf = res if return_margin else (res, None)
    res = sgm_wta_pallas_dmajor(cost, p, interpret=True,
                                return_margin=return_margin)
    disp, margin = res if return_margin else (res, None)
    disp = speckle_filter_pallas(
        disp, invalid=jstereo.INVALID(p), max_diff=float(p.speckle_range),
        min_region=p.speckle_window_size,
        value_range=(float(p.min_disparity),
                     float(p.min_disparity + p.num_disparities)),
        interpret=True)
    if not return_margin:
        return np.asarray(disp), None
    conf = jstereo.match_confidence(
        margin, jstereo.texture_energy(lf.astype(jnp.float32),
                                       p.prefilter_cap))
    return np.asarray(disp), np.asarray(conf)


@pytest.mark.parametrize("w,return_margin", [(128, True), (96, False)])
def test_sgbm_disparity_matches_tpu_path(w, return_margin):
    r = np.random.default_rng(21)
    h, shift = 24, 4
    base = r.uniform(0, 255, (1, h, w + shift)).astype(np.float32)
    left = base[:, :, :w].copy()
    right = base[:, :, shift:shift + w].copy()
    jp = jstereo.SGBMParams(num_disparities=16)
    p = stereo.SGBMParams(num_disparities=16)
    want, want_conf = _jax_tpu_path(left, right, jp, return_margin)
    got = stereo.sgbm_disparity(torch.from_numpy(left),
                                torch.from_numpy(right), p,
                                return_margin=return_margin)
    if return_margin:
        got, conf = got
        np.testing.assert_allclose(conf.numpy(), want_conf, rtol=1e-5,
                                   atol=1e-6)
    got = got.numpy()
    np.testing.assert_array_equal(got >= 0, want >= 0)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (got >= 0).mean() > 0.3
    assert np.median(got[got >= 0]) == pytest.approx(shift, abs=0.5)


def test_unported_configurations_raise():
    x = torch.zeros((1, 8, 32))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        stereo.sgbm_disparity(x, x, stereo.SGBMParams(min_disparity=-4))
