"""The port's flow ops and the plain twins of kernels B5 and B6 vs JAX.

Same numpy inputs (fixed seeds) go to both packages. The JAX Pallas
kernels run in interpret mode on CPU, as tests/test_flow.py runs them.
Tolerances: B5 atol 1e-5 (the JAX package's own Pallas-vs-XLA bound for
the warp); B6 and one refinement level atol 2e-4 px (its bound for the
matcher, whose sums run in another order); the estimators 1e-3 px; the
resamplers 1e-3 on a 0-255 scale (matmul summation order); one EMA step
0.05 on a 1000-scale depth, as the scan. The kernels' tap tables rebuild
the bilinear matrix bit for bit. The CUDA kernels are held against their
twins on the card (marked ``cuda``).
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
from video3d_tpu_torch.tools import card_checks

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


@pytest.mark.parametrize("shape,incoming", [
    ((37, 53), "coarse"),   # from (19, 27): odd coarse sizes, ratio != 2
    ((48, 64), "coarse"),
    ((27, 41), "coarse"),   # from (14, 21)
    ((37, 53), "same"),     # the coarsest level's second step
    ((37, 53), "none"),     # the first step
])
@pytest.mark.parametrize("use_pallas", [True, False])
def test_flow_level_twin_matches_jax(shape, incoming, use_pallas):
    cur, prev, _, _ = _match_inputs(shape, seed=9)
    h, w = shape
    rng = np.random.default_rng(10)
    fshape = {"coarse": (-(-h // 2), -(-w // 2)), "same": shape,
              "none": shape}[incoming]
    fy = rng.uniform(-4, 4, fshape).astype(np.float32)
    fx = rng.uniform(-4, 4, fshape).astype(np.float32)
    if incoming == "none":
        fy[:] = fx[:] = 0.0
    got = tflow.flow_level(T(cur), T(prev),
                           None if incoming == "none" else T(fy),
                           None if incoming == "none" else T(fx),
                           search=2, radius=3, tau=2.0, r=5)
    jfy, jfx = _j(fy, fx)
    if incoming == "coarse":
        jfy = jflow._resize_bl(jfy, h, w) * (h / fshape[0])
        jfx = jflow._resize_bl(jfx, h, w) * (w / fshape[1])
    want = jflow._flow_level_fast(*_j(cur, prev), jfy, jfx, search=2,
                                  radius=3, tau=2.0, warp_r=5,
                                  use_pallas=use_pallas, interpret=True)
    for g, wv in zip(got, want):
        assert g.shape == shape
        np.testing.assert_allclose(g.numpy(), np.asarray(wv), atol=2e-4)


@pytest.mark.parametrize("max_warp", [8, 16])
@pytest.mark.parametrize("gain", [0.0, 1.0])
def test_ema_step_matches_jax(max_warp, gain):
    """One frame of a scene panning 4 px (1 px at the 1/4 guide), the carry
    a noisy copy of the last frame."""
    rng = np.random.default_rng(12)
    h, w, s = 64, 96, 4
    big_d = smooth_texture(rng, h, w + 4, scale=1000.0)
    big_g = smooth_texture(rng, h // s, w // s + 1)
    prev_out = (big_d[:, :w] + rng.normal(0, 5, (h, w))).astype(np.float32)
    depth = big_d[:, 4:].copy()
    prev_g, g = big_g[:, :-1].copy(), big_g[:, 1:].copy()
    tp = tflow.FlowEMAParams(max_warp=max_warp, d_gate_gain=gain)
    jp = jflow.FlowEMAParams(max_warp=max_warp, d_gate_gain=gain)
    (carry, _), got = tflow._ema_step(tp, (T(prev_out), T(prev_g)), T(depth),
                                      T(g))
    (_, _), want = jflow._ema_step(jp, _j(prev_out, prev_g), _j(depth, g))
    assert carry is got
    err = np.abs(got.numpy() - np.asarray(want))
    assert err.max() < 0.05, err.max()
    # written in place when asked, the same values
    out = torch.empty((h, w))
    _, again = tflow._ema_step(tp, (T(prev_out), T(prev_g)), T(depth), T(g),
                               out)
    assert again is out and torch.equal(out, got)


# the level sizes of flow_scale 4 and 2 on a 1080p film (270x480 and
# 540x960 guides at 3 levels), the full-resolution upsample, identity
@pytest.mark.parametrize("n_in,n_out", [
    (68, 135), (135, 270), (120, 240), (240, 480), (270, 540), (480, 960),
    (270, 1080), (480, 1920), (540, 1080), (960, 1920), (2, 2), (37, 37),
    (1, 5),
])
def test_bilinear_taps_rebuild_the_matrix(n_in, n_out):
    idx, w = timage.bilinear_taps(n_in, n_out)
    assert idx.dtype == np.int32 and w.dtype == np.float32
    assert idx.shape == w.shape == (n_out, 2)
    assert (idx[:, 0] <= idx[:, 1]).all()
    dense = np.zeros((n_in, n_out), dtype=np.float32)
    for k in range(2):
        np.add.at(dense, (idx[:, k], np.arange(n_out)), w[:, k])
    want = timage.resample_matrix(n_in, n_out, "bilinear")
    assert dense.tobytes() == want.tobytes()
    np.testing.assert_array_equal(
        want, np.asarray(jimage.resample_matrix(n_in, n_out, "bilinear")))


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


@pytest.mark.cuda
@pytest.mark.parametrize("case", card_checks.FLOW_LEVEL_CASES[:4], ids=str)
def test_cuda_flow_level_matches_twin(cuda_device, case):
    card_checks.check_flow_level(cuda_device, *case)


@pytest.mark.cuda
@pytest.mark.parametrize("case", card_checks.EMA_CASES[:5], ids=str)
def test_cuda_ema_tail_matches_twin(cuda_device, case):
    card_checks.check_ema_tail(cuda_device, *case)
