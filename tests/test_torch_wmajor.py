"""The port's W-major horizontal route (B8b, B8c) and the int16 probe (P).

Seeded numpy inputs go through the JAX functions (Pallas in interpret
mode on CPU) and the port's plain twins on CPU tensors; the B8b and B8c
twins must agree with the JAX kernels exactly (their values are
integers), and every route of the port's matcher must give the legacy
route's disparities bit for bit, as tests/test_sgm_pallas.py:216-243
asserts for the JAX package. The CUDA kernels are held against the twins
on the card (marked ``cuda``).
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from video3d_tpu.kernels.costvol import fused_cost_volume
from video3d_tpu.kernels.sgm import (_directional_pass_wmajor,
                                     _horizontal_passes_wmajor,
                                     transpose_from_wmajor,
                                     transpose_to_wmajor)
from video3d_tpu.ops.stereo import xsobel_clip
from video3d_tpu_torch.kernels import sgm, wmajor
from video3d_tpu_torch.ops import stereo
from video3d_tpu_torch.tools import probe_i16

ND = 8


def _cost_i16(seed, h, w, shift=3):
    """JAX B1 on a shifted prefiltered pair: int16 (B, H, D, W)."""
    r = np.random.default_rng(seed)
    base = r.uniform(0, 255, (2, h, w + shift)).astype(np.float32)
    left = xsobel_clip(jnp.asarray(base[:, :, :w]), 63)
    right = xsobel_clip(jnp.asarray(base[:, :, shift:shift + w]), 63)
    return np.array(fused_cost_volume(left, right, ND, 5,
                                      out_dtype=jnp.int16,
                                      raw_invalid=126.0, interpret=True))


@pytest.fixture(scope="module")
def cost_40x128():
    return _cost_i16(13, 40, 128)


def test_b8b_twins_match_jax_roundtrip():
    r = np.random.default_rng(17)
    x = r.integers(0, 30000, (2, 40, 8, 256)).astype(np.int16)
    t = np.asarray(transpose_to_wmajor(jnp.asarray(x), interpret=True))
    back = np.asarray(transpose_from_wmajor(jnp.asarray(t), 40,
                                            interpret=True))
    xt = torch.from_numpy(x).permute(0, 1, 3, 2).contiguous()  # (B, H, W, D)
    got = wmajor.transpose_to_wmajor(xt)
    assert got.shape == t.shape == (2, 8, 256, 128)
    np.testing.assert_array_equal(got[..., :40].numpy(), t[..., :40])
    assert not got[..., 40:].any()  # the port zeros the padding lanes
    got_back = wmajor.transpose_from_wmajor(got, 40)
    np.testing.assert_array_equal(got_back.permute(0, 1, 3, 2).numpy(), back)
    assert torch.equal(got_back, xt)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("acc_dtype", [np.int16, np.float32])
def test_b8c_sweep_twin_matches_jax(cost_40x128, reverse, acc_dtype):
    cost_t = np.ascontiguousarray(cost_40x128.transpose(0, 2, 3, 1))
    r = np.random.default_rng(3)
    acc = r.integers(0, 10000, cost_t.shape).astype(acc_dtype)
    want = np.asarray(_directional_pass_wmajor(
        jnp.asarray(cost_t), jnp.asarray(acc), 600.0, 2400.0, reverse,
        interpret=True))
    got = wmajor.wmajor_sweep(torch.from_numpy(cost_t),
                              torch.from_numpy(acc), 600.0, 2400.0, reverse)
    assert got.dtype == torch.from_numpy(acc).dtype
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("acc_dtype", [torch.int16, torch.float32])
def test_b8c_both_directions_twin_matches_jax(acc_dtype):
    """The twin of B8c's two-direction entry vs JAX
    ``_horizontal_passes_wmajor`` at an odd height and width: exact."""
    r = np.random.default_rng(19)
    cost = r.integers(0, 1551, (1, 37, 16, 100)).astype(np.int16)
    want = np.asarray(_horizontal_passes_wmajor(
        jnp.asarray(cost), 600.0, 2400.0,
        jnp.int16 if acc_dtype == torch.int16 else jnp.float32,
        interpret=True, route="xla"))  # (B, H, D, W)
    cost_t = torch.from_numpy(cost.transpose(0, 2, 3, 1).copy())
    got = wmajor.horizontal_sweeps_wmajor_kernel(cost_t, 600.0, 2400.0,
                                                 acc_dtype)
    assert got.dtype == acc_dtype and got.shape == cost_t.shape
    np.testing.assert_array_equal(got.permute(0, 3, 1, 2).numpy(), want)


@pytest.mark.parametrize("route", ["xla", "mxu"])
@pytest.mark.parametrize("paths", [5, 8])
def test_b8c_horizontal_passes_match_jax(cost_40x128, paths, route):
    """Both W-major sweeps behind either layout change, vs JAX
    ``_horizontal_passes_wmajor`` (int16 accumulator at 5 paths, f32 at
    8): exact, and equal to B2's legacy sweeps."""
    p = stereo.SGBMParams(num_disparities=ND, num_paths=paths)
    acc_dtype = stereo.acc_dtype_for_params(torch.int16, p)
    want = np.asarray(_horizontal_passes_wmajor(
        jnp.asarray(cost_40x128), p.p1, p.p2,
        jnp.float32 if acc_dtype == torch.float32 else jnp.int16,
        interpret=True, route=route))
    cost = torch.from_numpy(cost_40x128).permute(0, 1, 3, 2).contiguous()
    got = wmajor.horizontal_sweeps_wmajor(cost, p, route)
    assert got.dtype == acc_dtype
    np.testing.assert_array_equal(got.permute(0, 1, 3, 2).numpy(), want)
    assert torch.equal(got, sgm.horizontal_sweeps(cost, p))


@pytest.mark.parametrize("w", [128, 100])
@pytest.mark.parametrize("route", ["xla", "mxu"])
@pytest.mark.parametrize("paths", [5, 8])
def test_routes_match_legacy(paths, route, w):
    r = np.random.default_rng(13)
    h, shift = 40, 3
    base = r.uniform(0, 255, (2, h, w + shift)).astype(np.float32)
    left = torch.from_numpy(base[:, :, :w].copy())
    right = torch.from_numpy(base[:, :, shift:shift + w].copy())
    p = stereo.SGBMParams(num_disparities=ND, speckle_window_size=0,
                          num_paths=paths)
    want, want_c = stereo.sgbm_disparity(left, right, p, return_margin=True)
    got, got_c = stereo.sgbm_disparity(left, right, p, return_margin=True,
                                       horizontal_route=route)
    assert torch.equal(got, want) and torch.equal(got_c, want_c)
    assert (got >= 0).float().mean() > 0.3


def test_probe_ops_on_cpu(capsys):
    """P: every op's CPU path is its torch expression, so the probe reports
    OK for all six; the ops' wrap-around and halving semantics are the
    JAX probe's."""
    res = probe_i16.run("cpu")
    assert list(res) == list(probe_i16.OPS) and len(res) == 6
    assert all(v == 0 for v in res.values())
    assert capsys.readouterr().out.count(" OK ") == 6
    a, b, c = (torch.tensor([[30000, -2, 7, 5, 1]], dtype=torch.int16)
               for _ in range(3))
    assert probe_i16.probe_op("i16 add", a, b).tolist() == [
        [-5536, -4, 14, 10, 2]]
    assert probe_i16.probe_op("i16 add+sub (ring update)", a, b, c).tolist() \
        == a.tolist()
    assert probe_i16.probe_op("i16 shift/and (halving)", a).tolist() == [
        [15000, -1, 4, 3, 1]]
    assert probe_i16.probe_op("i16->f32 cast + roll", a).tolist() == [
        [1, 30000, -2, 7, 5]]
    assert probe_i16.main(["--device", "cpu"]) == 0


@pytest.fixture(scope="module")
def jax_probe_kernels():
    """name -> (toy kernel, inputs) of the JAX probe, taken from its own
    ``main`` (the toy bodies are nested there) by intercepting ``run``."""
    path = Path(__file__).resolve().parents[1] / "tools" / "probe_i16.py"
    spec = importlib.util.spec_from_file_location("_jax_probe_i16", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    kernels = {}
    mod.run = lambda name, kernel, n_in, **_: kernels.update(
        {name: (kernel, n_in)})
    mod.main()
    return kernels


@pytest.mark.parametrize("full_range", [False, True])
@pytest.mark.parametrize("name", list(probe_i16.OPS))
def test_probe_ops_match_jax_probe(jax_probe_kernels, name, full_range):
    """P: each port op equals the JAX probe's toy kernel (Pallas in
    interpret mode) bit for bit, on the probe's inputs and on full-range
    ones, where int16 add wraps and the f32 -> int16 cast saturates."""
    assert list(jax_probe_kernels) == list(probe_i16.OPS)
    kernel, n_in = jax_probe_kernels[name]
    assert n_in == probe_i16.OPS[name][1]
    xs = probe_i16.probe_inputs("cpu", 5, full_range)[:n_in]
    if full_range:
        assert (xs[0].int() * 2).abs().max() > 32767
    want = np.asarray(pl.pallas_call(
        kernel, out_shape=jax.ShapeDtypeStruct(probe_i16.SHAPE, jnp.int16),
        interpret=True)(*(jnp.asarray(x.numpy()) for x in xs)))
    got = probe_i16.probe_op(name, *xs)
    assert got.dtype == torch.int16
    np.testing.assert_array_equal(got.numpy(), want)


# ---------------------------------------------------------------------------
# On the card: B8b, B8c and P against their twins
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int16, torch.float32])
def test_cuda_b8b_matches_twin(cuda_device, dtype):
    r = np.random.default_rng(1)
    x = torch.from_numpy(r.integers(0, 30000, (2, 70, 90, 40))).to(
        cuda_device, dtype)
    t = wmajor.transpose_to_wmajor(x)
    assert torch.equal(t, wmajor.transpose_to_wmajor_plain(x))
    assert torch.equal(wmajor.transpose_from_wmajor(t, 70), x)


@pytest.mark.cuda
@pytest.mark.parametrize("cost_dtype,acc_dtype",
                         [(torch.int16, torch.int16),
                          (torch.int16, torch.float32),
                          (torch.float32, torch.float32)])
@pytest.mark.parametrize("reverse", [False, True])
def test_cuda_b8c_matches_twin(cuda_device, reverse, cost_dtype, acc_dtype):
    r = np.random.default_rng(2)
    cost_t = torch.from_numpy(r.integers(0, 1550, (2, 64, 90, 70))).to(
        cuda_device, cost_dtype)
    acc = torch.from_numpy(r.integers(0, 10000, cost_t.shape)).to(
        cuda_device, acc_dtype)
    want = wmajor.wmajor_sweep_plain(cost_t, acc, 600.0, 2400.0, reverse)
    got = wmajor.wmajor_sweep(cost_t, acc.clone(), 600.0, 2400.0, reverse)
    assert torch.equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("cost_dtype,acc_dtype",
                         [(torch.int16, torch.int16),
                          (torch.int16, torch.float32),
                          (torch.float32, torch.float32)])
def test_cuda_b8c_horizontal_matches_twin(cuda_device, cost_dtype,
                                          acc_dtype):
    """B8c's two-direction entry, one launch, equals its twin."""
    r = np.random.default_rng(2)
    cost_t = torch.from_numpy(r.uniform(0, 1550, (2, 64, 90, 70))).to(
        cuda_device, cost_dtype)
    p1, p2 = (600.0, 2400.0) if cost_dtype == torch.int16 else (7.25, 30.5)
    want = wmajor.horizontal_sweeps_wmajor_plain(cost_t, p1, p2, acc_dtype)
    n = wmajor.sweep_launches
    got = wmajor.horizontal_sweeps_wmajor_kernel(cost_t, p1, p2, acc_dtype)
    assert wmajor.sweep_launches == n + 1
    assert torch.equal(got, want)


@pytest.mark.cuda
def test_cuda_probe_ops(cuda_device):
    """Each kernel equals its twin (held against the JAX probe above) on
    the probe's inputs and on full-range ones."""
    assert all(v == 0 for v in probe_i16.run(cuda_device).values())
