"""The port's hole fill vs the JAX ``fill_holes``: exactly equal.

Same numpy disparity maps (fixed seeds) go to both. The JAX function
propagates by log-step doubling, the port by a running max/min of valid
column indices and a gather; the filled values are copies of valid
pixels, so the results must be equal bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video3d_tpu.ops.fill import fill_holes as jax_fill
from video3d_tpu_torch.ops.fill import fill_holes

INVALID = -1.0


def _maps(case: str) -> np.ndarray:
    r = np.random.default_rng(7)
    d = r.uniform(0.0, 64.0, (3, 12, 40)).astype(np.float32)
    if case == "random":
        d[r.random(d.shape) < 0.35] = INVALID
    elif case == "blank_rows":
        d[r.random(d.shape) < 0.3] = INVALID
        d[0, 3] = INVALID
        d[2, :5] = INVALID
    elif case == "all_valid":
        pass
    elif case == "edges":
        d[:, :, :6] = INVALID  # holes touching the left edge
        d[:, :, -4:] = INVALID  # and the right edge
        d[1, 5, 10:30] = INVALID
    elif case == "single_valid":
        d[:] = INVALID
        d[0, 0, 17] = 3.5
        d[1, 4, 0] = 9.25
        d[2, 7, -1] = 1.0
    return d


@pytest.mark.parametrize(
    "case", ["random", "blank_rows", "all_valid", "edges", "single_valid"])
def test_fill_holes_equals_jax(case):
    d = _maps(case)
    want = np.asarray(jax_fill(jnp.asarray(d), INVALID))
    got = fill_holes(torch.from_numpy(d), INVALID)
    assert got.dtype == torch.float32 and got.shape == d.shape
    np.testing.assert_array_equal(got.numpy(), want)
    if case == "blank_rows":
        assert (got.numpy()[0, 3] == INVALID).all()
        rows_with_valid = (d != INVALID).any(-1, keepdims=True)
        assert not ((got.numpy() == INVALID) & rows_with_valid).any()
    if case == "all_valid":
        np.testing.assert_array_equal(got.numpy(), d)


def test_fill_holes_takes_the_background():
    """Each hole takes the smaller of its two nearest valid neighbours."""
    d = np.array([[5.0, INVALID, INVALID, 2.0, INVALID, 7.0, INVALID]],
                 np.float32)
    got = fill_holes(torch.from_numpy(d), INVALID).numpy()
    np.testing.assert_array_equal(got, [[5.0, 2.0, 2.0, 2.0, 2.0, 7.0, 7.0]])
