"""Kernel I1 (``video3d_tpu_torch/kernels/image.py``) on the CPU.

The kernel runs only on a CUDA card (``tests/test_torch_card.py``); here
its host side: the taps it reads are the Lanczos matrix's non-zero
entries, each among the pixels the kernel reads for its column, a float64
emulation of its sums gives today's image ops, and the wrapper's CPU path
is today's split, unsqueeze and gray, bit for bit.
"""

import numpy as np
import pytest
import torch

from video3d_tpu_torch.kernels import image
from video3d_tpu_torch.ops.image import (lanczos_taps, lanczos_taps_on,
                                         resample_matrix, resize_width,
                                         rgb_to_gray, unsqueeze_width)

LANCZOS_SHAPES = [(960, 1920), (1920, 3840), (5, 10), (7, 14), (129, 258)]


def _frames(b, h, w, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 256, (b, h, w, 3), dtype=np.uint8)


@pytest.mark.parametrize("n_in,n_out", LANCZOS_SHAPES)
def test_lanczos_taps_scatter_back_to_the_matrix(n_in, n_out):
    idx, w = lanczos_taps(n_in, n_out)
    assert idx.shape == w.shape == (n_out, 8)
    assert idx.dtype == np.int32 and w.dtype == np.float32
    assert (np.diff(idx, axis=1) >= 0).all()  # ascending, padding last
    dense = np.zeros((n_in, n_out), dtype=np.float32)
    np.add.at(dense, (idx, np.arange(n_out)[:, None]), w)
    np.testing.assert_array_equal(dense, resample_matrix(n_in, n_out,
                                                         "lanczos4"))


def test_lanczos_taps_merge_the_clipped_border_taps():
    idx, w = lanczos_taps(5, 10)
    # column 0 reads source -4..3, clipped to 0..3: four taps, padded
    assert list(idx[0]) == [0, 1, 2, 3, 3, 3, 3, 3]
    assert (w[0, 4:] == 0).all() and (w[0, :4] != 0).all()


@pytest.mark.parametrize("n_in,n_out", LANCZOS_SHAPES + [
    (480, 960), (540, 1080), (4, 8), (3, 6), (2, 4), (1, 2)])
def test_lanczos_taps_lie_in_each_columns_virtual_taps(n_in, n_out):
    """The kernel reads output column o's taps from the eye's pixels
    floor(src) - 3 .. floor(src) + 4 clamped to its edge, the virtual
    taps of ``resample_matrix`` (``csrc/image.cu Geo``), and gives each
    tap's weight to the first of them that reads its index: so every
    non-zero tap has to be among them, once."""
    idx, w = lanczos_taps(n_in, n_out)
    src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    virtual = np.floor(src).astype(np.int64)[:, None] + np.arange(-3, 5)
    reads = np.clip(virtual, 0, n_in - 1)
    for o in range(n_out):
        nz = idx[o][w[o] != 0]
        assert (np.diff(nz) > 0).all()
        assert np.isin(nz, reads[o]).all()


def test_lanczos_taps_on_uploads_the_table_once():
    idx, w = lanczos_taps(7, 14)
    di, dw = lanczos_taps_on(7, 14, torch.device("cpu"))
    assert torch.equal(di, torch.from_numpy(idx))
    assert torch.equal(dw, torch.from_numpy(w))
    assert lanczos_taps_on(7, 14, torch.device("cpu"))[0] is di


@pytest.mark.parametrize("n_in,n_out", [(960, 1920), (7, 14), (129, 258)])
def test_tap_sum_emulation_matches_resize_width(n_in, n_out):
    rng = np.random.default_rng(3)
    src = rng.uniform(0, 255, (4, n_in)).astype(np.float32)
    idx, w = lanczos_taps(n_in, n_out)
    emu = np.zeros((4, n_out))
    for t in range(8):  # ascending index order
        emu += w[:, t].astype(np.float64) * src[:, idx[:, t]]
    ref = resize_width(torch.from_numpy(src), n_out).numpy()
    assert np.abs(emu - ref).max() < 2e-4


def _emulate_kernel(frames, unsqueeze):
    """float64 emulation of the kernel's arithmetic: each output column's
    taps of :func:`lanczos_taps` (or its own pixel) weighed and summed in
    ascending index order, then BT.601, per eye."""
    b, h, w, _ = frames.shape
    w_in = w // 2
    out = []
    for eye in (frames[:, :, :w_in], frames[:, :, w_in:]):
        rgb = eye.astype(np.float64)
        if unsqueeze:
            idx, wts = lanczos_taps(w_in, 2 * w_in)
            src, rgb = rgb, np.zeros((b, h, 2 * w_in, 3))
            for t in range(idx.shape[1]):
                rgb += wts[:, t, None].astype(np.float64) * src[:, :, idx[:, t]]
        gray = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
        out.append((gray, rgb))
    return out


@pytest.mark.parametrize("shape", [(2, 5, 20), (3, 37, 258), (1, 4, 6)])
@pytest.mark.parametrize("unsqueeze", [True, False])
def test_kernel_emulation_matches_the_twin(shape, unsqueeze):
    frames = _frames(*shape, seed=5)
    gl, gr, rl, rr = image.eyes_gray(torch.from_numpy(frames), unsqueeze,
                                     want_rgb=True)
    for (gray, rgb), g, r in zip(_emulate_kernel(frames, unsqueeze),
                                 (gl, gr), (rl, rr)):
        assert np.abs(gray - g.numpy()).max() < 2e-4
        assert np.abs(rgb - r.numpy()).max() < 2e-4


def _todays_chain(x, unsqueeze):
    """The stage's image ops before the kernel: split, cast, unsqueeze
    through the dense matrix, BT.601, contiguous."""
    w_in = x.shape[2] // 2
    eyes = [x[:, :, :w_in].to(torch.float32), x[:, :, w_in:].to(torch.float32)]
    if unsqueeze:
        eyes = [unsqueeze_width(e.movedim(-1, 1)).movedim(1, -1) for e in eyes]
    return [rgb_to_gray(e).contiguous() for e in eyes], eyes


@pytest.mark.parametrize("want_rgb", [False, True])
@pytest.mark.parametrize("unsqueeze", [True, False])
def test_cpu_path_is_todays_chain(unsqueeze, want_rgb):
    x = torch.from_numpy(_frames(2, 9, 46, seed=2))
    n = image.launches
    gl, gr, rl, rr = image.eyes_gray(x, unsqueeze, want_rgb)
    assert image.launches == n  # no kernel on the CPU
    (wl, wr), (el, er) = _todays_chain(x, unsqueeze)
    assert torch.equal(gl, wl) and torch.equal(gr, wr)
    assert gl.is_contiguous() and gr.is_contiguous()
    if not want_rgb:
        assert rl is None and rr is None
        return
    for got, want in ((rl, el), (rr, er)):
        assert torch.equal(got, want)
        assert got.stride() == want.stride()

