"""The port's flow ops and the plain twins of kernels B5 and B6 vs JAX.

Same numpy inputs (fixed seeds) go to both packages. The JAX Pallas
kernels run in interpret mode on CPU, as tests/test_flow.py runs them.
Tolerances: B5 atol 1e-5 (the JAX package's own Pallas-vs-XLA bound for
the warp); B6 and one refinement level atol 2e-4 px (its bound for the
matcher, whose sums run in another order); the estimators 1e-3 px; the
resamplers 1e-3 on a 0-255 scale (matmul summation order). The CUDA
kernels are held against their twins on the card (marked ``cuda``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_flow import smooth_texture
from video3d_tpu.kernels.flowmatch import flow_match_pallas
from video3d_tpu.kernels.warp import warp_bilinear_shifts_pallas
from video3d_tpu.ops import flow as jflow
from video3d_tpu.ops import image as jimage
from video3d_tpu_torch.kernels import flowmatch, warp
from video3d_tpu_torch.ops import flow as tflow
from video3d_tpu_torch.ops import image as timage

T = torch.from_numpy


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _warp_inputs(shape, r, seed=21):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal(shape).astype(np.float32)
    # past the clamp on purpose: both sides must clamp to [-r, r]
    fy = rng.uniform(-r - 1, r + 1, shape).astype(np.float32)
    fx = rng.uniform(-r - 1, r + 1, shape).astype(np.float32)
    return img, fy, fx


def _match_inputs(shape, seed=3):
    rng = np.random.default_rng(seed)
    h, w = shape
    cur = smooth_texture(rng, h, w)
    prev = smooth_texture(rng, h, w)
    fy = rng.uniform(-3, 3, shape).astype(np.float32)
    fx = rng.uniform(-3, 3, shape).astype(np.float32)
    return cur, prev, fy, fx


@pytest.mark.parametrize("dy,dx", [(0, 0), (1, 0), (0, -2), (-3, 2),
                                   (2, 3), (9, -12)])
def test_shift_edge_matches_jax(dy, dx):
    a = np.random.default_rng(0).standard_normal((2, 7, 9)).astype(np.float32)
    np.testing.assert_array_equal(
        tflow.shift_edge(T(a), dy, dx).numpy(),
        np.asarray(jflow.shift_edge(jnp.asarray(a), dy, dx)))


@pytest.mark.parametrize("shape,r", [((48, 128), 5), ((96, 96), 5),
                                     ((37, 53), 5), ((40, 56), 16)])
def test_b5_twin_matches_pallas_and_xla(shape, r):
    img, fy, fx = _warp_inputs(shape, r)
    got = warp.warp_bilinear_shifts(T(img), T(fy), T(fx), r).numpy()
    pallas = warp_bilinear_shifts_pallas(*_j(img, fy, fx), r, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=1e-5)
    fyc, fxc = np.clip(fy, -r, r), np.clip(fx, -r, r)
    xla = jflow._warp_axis_shifts(
        jflow._warp_axis_shifts(jnp.asarray(img), jnp.asarray(fyc), r, True),
        jnp.asarray(fxc), r, False)
    np.testing.assert_allclose(got, np.asarray(xla), atol=1e-5)


def test_gather_warp_matches_jax():
    img, fy, fx = _warp_inputs((30, 44), 4, seed=5)
    got = tflow.warp_bilinear(T(img), T(fy), T(fx)).numpy()
    want = jflow.warp_bilinear(*_j(img, fy, fx))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("shape", [(48, 64), (37, 53)])
def test_b6_twin_matches_pallas(shape):
    cur, prev_w, fy, fx = _match_inputs(shape)
    got = flowmatch.flow_match(T(cur), T(prev_w), T(fy), T(fx), search=2,
                               radius=3, tau=2.0)
    want = flow_match_pallas(*_j(cur, prev_w, fy, fx), search=2, radius=3,
                             tau=2.0, interpret=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4)


@pytest.mark.parametrize("shape", [(48, 64), (37, 53)])
def test_flow_level_fast_matches_xla(shape):
    cur, prev, fy, fx = _match_inputs(shape, seed=4)
    got = tflow._flow_level_fast(T(cur), T(prev), T(fy), T(fx), search=2,
                                 radius=3, tau=2.0, warp_r=4)
    want = jflow._flow_level_fast(*_j(cur, prev, fy, fx), search=2,
                                  radius=3, tau=2.0, warp_r=4,
                                  use_pallas=False)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4)


def _shifted_pair(dy, dx, h=96, w=128, seed=11):
    base = smooth_texture(np.random.default_rng(seed), h + 16, w + 16)
    prev = base[8:8 + h, 8:8 + w].copy()
    cur = base[8 + dy:8 + dy + h, 8 + dx:8 + dx + w].copy()
    return cur, prev


@pytest.mark.parametrize("fast", [True, False])
def test_estimators_match_jax(fast):
    cur, prev = _shifted_pair(2, -3)
    if fast:
        got = tflow.estimate_flow_fast(T(cur), T(prev), max_flow=6)
        want = jflow.estimate_flow_fast(*_j(cur, prev), max_flow=6)
    else:
        got = tflow.estimate_flow(T(cur), T(prev))
        want = jflow.estimate_flow(*_j(cur, prev))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-3)
    # and it finds the motion: cur(x) = prev(x + (2, -3))
    m = 16
    assert abs(got[0][m:-m, m:-m].mean().item() - 2) < 0.5
    assert abs(got[1][m:-m, m:-m].mean().item() + 3) < 0.5


@pytest.mark.parametrize("h_out,w_out", [(24, 40), (7, 13), (40, 96)])
@pytest.mark.parametrize("method", ["bilinear", "lanczos4"])
def test_resize_matches_jax(h_out, w_out, method):
    img = np.random.default_rng(2).uniform(
        0, 255, (2, 27, 48)).astype(np.float32)
    np.testing.assert_allclose(
        timage.resize2d(T(img), h_out, w_out, method).numpy(),
        np.asarray(jimage.resize2d(jnp.asarray(img), h_out, w_out, method)),
        atol=1e-3)
    np.testing.assert_allclose(
        timage.resize_height(T(img), h_out, method).numpy(),
        np.asarray(jimage.resize_height(jnp.asarray(img), h_out, method)),
        atol=1e-3)


def test_flow_ema_params_pinned():
    ported = tflow.flow_ema_params_from_jax(jflow.FlowEMAParams()._asdict())
    assert ported == tflow.FlowEMAParams()
    assert tflow.FlowEMAParams._fields == jflow.FlowEMAParams._fields
    assert tuple(tflow.FlowEMAParams()) == tuple(jflow.FlowEMAParams())
    custom = jflow.FlowEMAParams(levels=4, max_warp=8, d_gate_gain=0.0)
    assert tuple(tflow.flow_ema_params_from_jax(custom._asdict())) == \
        tuple(custom)
    with pytest.raises(ValueError, match="unknown"):
        tflow.flow_ema_params_from_jax({"alpha": 0.5})


def test_flow_ema_scan_matches_jax():
    """Four frames of a scene panning 4 px/frame (1 px at the 1/4 guide),
    one scan from frame 0."""
    rng = np.random.default_rng(8)
    t, h, w, s = 4, 64, 96, 4
    big_d = smooth_texture(rng, h, w + 4 * t, scale=1000.0)
    big_g = smooth_texture(rng, h // s, (w + 4 * t) // s)
    depth = np.stack([big_d[:, 4 * i:4 * i + w] for i in range(t)])
    guide = np.stack([big_g[:, i:i + w // s] for i in range(t)])
    p = tflow.FlowEMAParams()
    _, got = tflow.flow_ema_scan(None, T(depth), T(guide), p)
    _, want = jflow.flow_ema_scan(None, *_j(depth, guide),
                                  jflow.FlowEMAParams())
    err = np.abs(got.numpy() - np.asarray(want))
    # 1000-scale depth: 0.05 units is ~5e-5 relative
    assert err.max() < 0.05, err.max()


# ---------------------------------------------------------------------------
# On the card: B5 and B6 against their plain twins
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("shape,r", [((270, 480), 6), ((37, 53), 4),
                                     ((540, 960), 16)])
def test_cuda_b5_matches_twin(cuda_device, shape, r):
    img, fy, fx = (T(a).to(cuda_device) for a in _warp_inputs(shape, r))
    launches = warp.launches
    got = warp.warp_bilinear_shifts(img, fy, fx, r)
    want = tflow.warp_bilinear_shifts_plain(img, fy, fx, r)
    assert warp.launches == launches + 1
    assert (got - want).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(270, 480), (37, 53), (5, 7)])
def test_cuda_b6_matches_twin(cuda_device, shape):
    args = [T(a).to(cuda_device) for a in _match_inputs(shape)]
    launches = flowmatch.launches
    got = flowmatch.flow_match(*args, search=2, radius=3, tau=2.0)
    want = tflow.flow_match_plain(*args, search=2, radius=3, tau=2.0)
    assert flowmatch.launches == launches + 1
    for g, w in zip(got, want):
        assert (g - w).abs().max().item() <= 2e-4
