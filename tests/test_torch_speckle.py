"""Plain twin of kernel B4 (speckle vote) vs the JAX Pallas kernel.

``speckle_filter_pallas`` runs in interpret mode on CPU; the port's twin
on CPU tensors of the same numpy input. Bit-exact.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video3d_tpu.kernels.speckle import speckle_filter_pallas
from video3d_tpu_torch.kernels import speckle


@pytest.mark.parametrize("h,w,min_region", [(24, 64, 100), (16, 96, 9)])
def test_b4_speckle_twin_exact(h, w, min_region):
    r = np.random.default_rng(3)
    disp = r.uniform(0, 64, (1, h, w)).astype(np.float32)
    disp[r.uniform(size=disp.shape) < 0.3] = -1.0
    want = speckle_filter_pallas(jnp.asarray(disp), invalid=-1.0,
                                 max_diff=32.0, min_region=min_region,
                                 interpret=True)
    got = speckle.speckle_filter(torch.from_numpy(disp), invalid=-1.0,
                                 max_diff=32.0, min_region=min_region)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
