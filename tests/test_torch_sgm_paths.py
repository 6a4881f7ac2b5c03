"""The port's SGM modes (2, 4, 5 and 8 paths) vs the JAX package.

Seeded numpy inputs go through the JAX functions -- the Pallas kernels in
interpret mode on CPU, as tests/test_sgm_pallas.py runs them -- and
through the port's counterparts on CPU tensors (the plain twins of B1, B2,
B3 and B8a). Tolerances are the JAX tests' own: 1e-3 for float path sums
(tests/test_sgm_pallas.py:35-39); for disparity, identical validity and
1e-5, as B3 was held at 5 paths. The CUDA kernels are held against the
twins on the card (marked ``cuda``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_kernels import _gray_pair
from video3d_tpu.kernels.costvol import fused_cost_volume
from video3d_tpu.kernels.sgm import (sgm_aggregate_pallas,
                                     sgm_aggregate_pallas_dmajor,
                                     sgm_wta_pallas_dmajor)
from video3d_tpu.ops import stereo as jstereo
from video3d_tpu_torch import kernels as tkernels
from video3d_tpu_torch.kernels import costvol, sgm
from video3d_tpu_torch.kernels.image import eyes_gray
from video3d_tpu_torch.ops import stereo
from video3d_tpu_torch.stages import depth as tdepth

PATHS = [2, 4, 5, 8]
ND = 16


@pytest.fixture(scope="module")
def cost_f32():
    """The JAX tests' (2, 12, 16, 8) f32 (B, H, W, D) cost."""
    r = np.random.default_rng(0)
    return r.uniform(0, 100, (2, 12, 16, 8)).astype(np.float32)


@pytest.mark.parametrize("paths", PATHS)
def test_plain_sgm_aggregate_matches_jax(cost_f32, paths):
    jp = jstereo.SGBMParams(num_paths=paths, p1=6.0, p2=24.0)
    ref = np.asarray(jstereo.sgm_aggregate(jnp.asarray(cost_f32), jp))
    pal = np.asarray(sgm_aggregate_pallas(jnp.asarray(cost_f32), paths, 6.0,
                                          24.0, interpret=True))
    p = stereo.SGBMParams(num_paths=paths, p1=6.0, p2=24.0)
    got = stereo.sgm_aggregate(torch.from_numpy(cost_f32), p)
    assert got.dtype == torch.float32 and got.shape == cost_f32.shape
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-3)
    np.testing.assert_allclose(got.numpy(), pal, atol=1e-3)
    # B8a's public entry sends a CPU tensor to this twin
    assert torch.equal(tkernels.sgm_aggregate_pallas(
        torch.from_numpy(cost_f32), paths, 6.0, 24.0), got)


@pytest.mark.parametrize("paths", PATHS)
def test_sgm_aggregate_dmajor_matches_jax(cost_f32, paths):
    cost_d = np.ascontiguousarray(np.moveaxis(cost_f32, -1, -2))
    ref = np.asarray(jstereo.sgm_aggregate(
        jnp.asarray(cost_f32),
        jstereo.SGBMParams(num_paths=paths, p1=6.0, p2=24.0)))
    pal = np.asarray(sgm_aggregate_pallas_dmajor(
        jnp.asarray(cost_d), paths, 6.0, 24.0, interpret=True))
    got = sgm.sgm_aggregate_pallas_dmajor(torch.from_numpy(cost_d), paths,
                                          6.0, 24.0).numpy()
    np.testing.assert_allclose(np.moveaxis(got, -2, -1), ref, atol=1e-3)
    np.testing.assert_allclose(got, pal, atol=1e-3)


def test_sgm_aggregate_bf16_cost(cost_f32):
    """A bf16 cost sums in f32, as the TPU kernel's (sgm.py:157-159)."""
    bf = torch.from_numpy(cost_f32).to(torch.bfloat16)
    want = np.asarray(sgm_aggregate_pallas(
        jnp.asarray(bf.to(torch.float32).numpy()).astype(jnp.bfloat16), 8,
        6.0, 24.0, interpret=True))
    got = tkernels.sgm_aggregate_pallas(bf, 8, 6.0, 24.0)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


@pytest.fixture(scope="module")
def jax_cost_i16():
    """JAX B1 output on a shifted pair: int16 (B, H, D, W) cost."""
    left, right = _gray_pair(1, h=16, w=64)
    p = jstereo.SGBMParams(num_disparities=ND)
    return np.array(fused_cost_volume(
        jnp.asarray(left), jnp.asarray(right), ND, p.block_size,
        out_dtype=jnp.int16, raw_invalid=2.0 * p.prefilter_cap,
        interpret=True, prefilter_cap=p.prefilter_cap))


@pytest.mark.parametrize("paths,return_margin",
                         [(2, True), (4, False), (8, True), (8, False)])
def test_b3_modes_match_jax(jax_cost_i16, paths, return_margin):
    """B2 + B3 twins (8 paths: f32 accumulator, bottom-up close) vs JAX
    ``sgm_wta_pallas_dmajor`` on the same int16 cost."""
    jp = jstereo.SGBMParams(num_disparities=ND, num_paths=paths)
    p = stereo.SGBMParams(num_disparities=ND, num_paths=paths)
    want = sgm_wta_pallas_dmajor(jnp.asarray(jax_cost_i16), jp,
                                 interpret=True, return_margin=return_margin)
    cost = torch.from_numpy(jax_cost_i16).permute(0, 1, 3, 2).contiguous()
    acc = sgm.horizontal_sweeps(cost, p)
    assert acc.dtype == (torch.float32 if paths == 8 else torch.int16)
    got = sgm.vertical_sweeps_wta(cost, acc, p, return_margin=return_margin)
    if return_margin:
        (want, want_m), (got, got_m) = want, got
        np.testing.assert_allclose(got_m.numpy(), np.asarray(want_m),
                                   rtol=1e-6)
    want, got = np.asarray(want), got.numpy()
    np.testing.assert_array_equal(got >= 0, want >= 0)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert (got >= 0).mean() > 0.3


def test_f32_accumulator_sweep_matches_jax(jax_cost_i16):
    """B2's twin into an f32 accumulator, bottom-up with both diagonals,
    vs JAX ``_directional_pass_dmajor``: exact."""
    from video3d_tpu.kernels.sgm import _directional_pass_dmajor

    r = np.random.default_rng(2)
    acc = r.integers(0, 20000, jax_cost_i16.shape).astype(np.float32)
    want = _directional_pass_dmajor(jnp.asarray(jax_cost_i16),
                                    jnp.asarray(acc), (0, 1, -1), 600.0,
                                    2400.0, True, interpret=True)
    got = stereo.sgm_sweep_dmajor(torch.from_numpy(jax_cost_i16),
                                  torch.from_numpy(acc), (0, 1, -1), 600.0,
                                  2400.0, True)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_mode_hh_worst_case_no_overflow():
    """All-max cost with 8 paths (the overflow worst case, 31600 > the
    int16 bound): the f32 accumulator agrees with the JAX f32 path."""
    h, w, nd = 16, 48, 8
    jp = jstereo.SGBMParams(num_disparities=nd, speckle_window_size=0,
                            num_paths=8)
    p = stereo.SGBMParams(num_disparities=nd, speckle_window_size=0,
                          num_paths=8)
    assert stereo.acc_dtype_for_params(torch.int16, p) == torch.float32
    assert stereo.acc_dtype_for_params(torch.int16,
                                       p.replace(num_paths=5)) == torch.int16
    cost_max = p.block_size**2 * 2 * p.prefilter_cap
    worst = np.full((1, h, nd, w), cost_max, np.int16)
    want = np.asarray(sgm_wta_pallas_dmajor(
        jnp.asarray(worst.astype(np.float32)), jp, interpret=True))
    cost = torch.from_numpy(worst).permute(0, 1, 3, 2).contiguous()
    got = sgm.vertical_sweeps_wta(cost, sgm.horizontal_sweeps(cost, p), p)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


def _jax_tpu_path(left, right, jp):
    """The JAX TPU matcher's composition, every kernel in interpret mode."""
    from video3d_tpu.kernels.speckle import speckle_filter_pallas

    cost = fused_cost_volume(
        jnp.asarray(left), jnp.asarray(right), jp.num_disparities,
        jp.block_size, out_dtype=jnp.int16,
        raw_invalid=2.0 * jp.prefilter_cap, interpret=True,
        prefilter_cap=jp.prefilter_cap)
    disp = sgm_wta_pallas_dmajor(cost, jp, interpret=True)
    return np.asarray(speckle_filter_pallas(
        disp, invalid=jstereo.INVALID(jp), max_diff=float(jp.speckle_range),
        min_region=jp.speckle_window_size,
        value_range=(float(jp.min_disparity),
                     float(jp.min_disparity + jp.num_disparities)),
        interpret=True))


@pytest.mark.parametrize("paths", [2, 4, 8])
def test_sgbm_disparity_modes_match_tpu_path(paths):
    r = np.random.default_rng(21)
    h, w, shift = 24, 96, 4
    base = r.uniform(0, 255, (1, h, w + shift)).astype(np.float32)
    left = base[:, :, :w].copy()
    right = base[:, :, shift:shift + w].copy()
    jp = jstereo.SGBMParams(num_disparities=ND, num_paths=paths)
    p = stereo.SGBMParams(num_disparities=ND, num_paths=paths)
    want = _jax_tpu_path(left, right, jp)
    got = stereo.sgbm_disparity(torch.from_numpy(left),
                                torch.from_numpy(right), p).numpy()
    np.testing.assert_array_equal(got >= 0, want >= 0)
    np.testing.assert_allclose(got, want, atol=1e-5)
    assert np.median(got[got >= 0]) == pytest.approx(shift, abs=0.5)


@pytest.mark.parametrize("paths", [2, 4, 8])
def test_extractor_modes_match_tpu_path(tmp_path, paths):
    """StereoDepthExtractor(params=SGBMParams(num_paths=...)) on the CPU
    writes the uint16 maps of the matcher that
    test_sgbm_disparity_modes_match_tpu_path holds against the JAX TPU
    path."""
    from video3d_tpu_torch.core import list_depth_frames, load_depth_png16

    r = np.random.default_rng(paths)
    h, w_eye, shift = 24, 64, 3
    base = r.integers(0, 256, (2, h, w_eye + shift, 3), dtype=np.uint8)
    frames = np.concatenate([base[:, :, :w_eye],
                             base[:, :, shift:shift + w_eye]], axis=2)
    p = stereo.SGBMParams(num_disparities=ND, num_paths=paths)
    ext = tdepth.StereoDepthExtractor(work_dir=str(tmp_path), params=p,
                                      unsqueeze_anamorphic=False,
                                      device="cpu", guidance="none")
    assert f"num_paths={paths}" in ext._model_key()
    assert ext._run_batches([(frames, 2)], tmp_path / "maps") == 2
    maps = np.stack([load_depth_png16(f)
                     for f in list_depth_frames(tmp_path / "maps")])
    gl, gr = eyes_gray(torch.from_numpy(frames), False)[:2]
    want = tdepth.disparity_to_uint16(stereo.sgbm_disparity(gl, gr, p), ND)
    np.testing.assert_array_equal(maps, want.numpy())
    assert (maps > 0).mean() > 0.3


@pytest.mark.parametrize("h,w", [(16, 64), (16, 48)])
def test_b1_i16_bit_exact(monkeypatch, h, w):
    """B1-i16: the JAX native-int16 cost kernel (``_cost_row_step_i16``)
    equals the port's B1 twin bit for bit, aligned or not."""
    monkeypatch.setenv("VIDEO3D_TPU_COSTVOL_NATIVE_I16", "1")
    left, right = _gray_pair(11, h=h, w=w)
    p = stereo.SGBMParams(num_disparities=ND)
    want = np.asarray(fused_cost_volume(
        jnp.asarray(left), jnp.asarray(right), ND, p.block_size,
        out_dtype=jnp.int16, raw_invalid=2.0 * p.prefilter_cap,
        interpret=True, prefilter_cap=p.prefilter_cap))
    got = costvol.cost_volume(torch.from_numpy(left),
                              torch.from_numpy(right), p,
                              2.0 * p.prefilter_cap)
    np.testing.assert_array_equal(got.permute(0, 1, 3, 2).numpy(), want)


def test_modes_and_penalties_checked():
    x = torch.zeros((1, 8, 32))
    for bad in (3, 6):
        with pytest.raises(ValueError, match="num_paths"):
            stereo.sgbm_disparity(x, x, stereo.SGBMParams(num_paths=bad))
    with pytest.raises(ValueError, match="sentinel"):
        stereo.sgbm_disparity(x, x, stereo.SGBMParams(num_paths=8,
                                                      p2=200000.0))
    with pytest.raises(ValueError, match="horizontal_route"):
        stereo.sgbm_disparity(x, x, horizontal_route="pallas")
    assert stereo.vertical_directions(2) == ()
    assert stereo.vertical_directions(5) == ((1, 0), (1, 1), (1, -1))
    assert stereo.vertical_directions(8) == ((1, 0), (1, 1), (1, -1),
                                             (-1, 0), (-1, 1), (-1, -1))


# ---------------------------------------------------------------------------
# On the card: B2/B3 at f32 accumulators against their twins (B8a's card
# cases are tests/test_torch_card.py test_b8a_matches_twin)
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("paths", PATHS)
def test_cuda_modes_match_twins(cuda_device, paths):
    left, right = _gray_pair(4, b=2, h=40, w=200)
    p = stereo.SGBMParams(num_paths=paths)
    lg = torch.from_numpy(left).to(cuda_device)
    rg = torch.from_numpy(right).to(cuda_device)
    cost = costvol.cost_volume(lg, rg, p, 2.0 * p.prefilter_cap)
    acc = sgm.horizontal_sweeps(cost, p)
    assert torch.equal(acc, sgm.horizontal_sweeps_plain(cost, p))
    disp_p, m_p = sgm.vertical_sweeps_wta_plain(cost, acc, p, True)
    disp, m = sgm.vertical_sweeps_wta(cost, acc.clone(), p, True)
    assert torch.equal(disp >= 0, disp_p >= 0)
    assert (disp - disp_p).abs().max().item() <= 1e-5
    assert torch.allclose(m, m_p, rtol=1e-6)
