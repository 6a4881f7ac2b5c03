"""Small-shape checks of kernels B1 and B3 against their plain twins.

The shapes stress what the 1080p run at D = 64 does not: widths that are
no multiple of a block's strip of columns, heights shorter than B1's ring
of rows and no multiple of one of its segments, disparity counts from one
lane-run to four (and ones no vector width divides), a non-zero
``min_disparity``, other block sizes, batches of 1 and 3 (and of enough
small frames that B3 picks its wider blocks), and for B3 every mode (2, 4,
5 and 8 paths) with and without the margin. ``chip_smoke.py``
and ``tests/test_torch_card.py`` both run them on the card; the functions
raise ``AssertionError`` on a mismatch.
"""

from __future__ import annotations

import numpy as np
import torch

from video3d_tpu_torch.kernels import costvol, sgm
from video3d_tpu_torch.ops.stereo import SGBMParams

# (batch, height, width, num_disparities, min_disparity, block_size)
B1_CASES = [
    (1, 5, 70, 16, 0, 5),
    (3, 9, 257, 32, 0, 5),
    (1, 137, 1000, 48, 0, 5),
    (3, 137, 70, 128, 0, 5),
    (1, 9, 257, 64, 3, 5),
    (1, 137, 257, 128, 3, 5),
    (1, 9, 70, 35, 0, 5),   # no vector width divides D
    (1, 9, 70, 50, 0, 5),   # pairs
    (1, 9, 70, 36, 3, 5),   # runs of four
    (1, 5, 70, 16, 0, 7),   # fewer rows than the ring holds
    (3, 2, 33, 16, 0, 3),
    (1, 70, 257, 64, 0, 9),
]

# (batch, height, width, num_disparities, min_disparity)
B3_SHAPES = [
    (1, 5, 70, 16, 0),
    (3, 9, 257, 32, 0),
    (1, 137, 1000, 48, 0),
    (3, 137, 257, 128, 0),
    (1, 9, 257, 64, 3),
    (1, 9, 257, 70, 0),  # three disparities a lane, no vector loads
    # batches of small frames that on an H100 (132 multiprocessors) make
    # B3 pick its 32-warp blocks, one per lane layout, the last in two
    # launches; then 16-warp blocks in two launches
    (132, 5, 70, 16, 0),
    (26, 9, 257, 64, 0),
    (14, 9, 257, 70, 0),
    (28, 9, 257, 128, 3),
    (31, 9, 257, 64, 0),
]
B3_CASES = [shape + (paths, margin) for shape in B3_SHAPES
            for paths in (2, 4, 5, 8) for margin in (False, True)]


def gray_pair(b: int, h: int, w: int, shift: int, seed: int, device):
    """(b, h, w) f32 eyes of one random texture, ``shift`` pixels apart."""
    r = np.random.default_rng(seed)
    base = r.uniform(0, 255, (b, h, w + shift)).astype(np.float32)
    return (torch.from_numpy(base[:, :, :w].copy()).to(device),
            torch.from_numpy(base[:, :, shift:shift + w].copy()).to(device))


def check_b1(device, b, h, w, d, min_d, block, seed=7) -> None:
    """B1 on the card equals its twin bit for bit, cost and filtered left."""
    p = SGBMParams(num_disparities=d, min_disparity=min_d, block_size=block)
    gl, gr = gray_pair(b, h, w, min(3 + min_d, w // 4), seed, device)
    inv = 2.0 * p.prefilter_cap
    n = costvol.launches
    cost, lf = costvol.cost_volume(gl, gr, p, inv, return_filtered_left=True)
    assert costvol.launches == n + 1
    cost_p, lf_p = costvol.cost_volume_plain(gl, gr, p, inv, True)
    torch.cuda.synchronize(device)
    what = f"B1 at {(b, h, w, d)} min_d {min_d} block {block}"
    assert cost.shape == (b, h, w, d) and cost.dtype == torch.int16, what
    assert torch.equal(lf, lf_p), f"{what}: filtered left differs"
    err = (cost.int() - cost_p.int()).abs().max().item()
    assert err == 0, f"{what}: max |err| {err}"


def check_b3(device, b, h, w, d, min_d, paths, margin, seed=8) -> None:
    """B3 on the card against its twin on B1's cost and B2's accumulator:
    identical validity, disparity within 1e-5, margin within rtol 1e-6;
    the horizontal accumulator is read, never the total."""
    p = SGBMParams(num_disparities=d, min_disparity=min_d, num_paths=paths)
    gl, gr = gray_pair(b, h, w, min(3 + min_d, w // 4), seed, device)
    cost = costvol.cost_volume(gl, gr, p, 2.0 * p.prefilter_cap)
    acc = sgm.horizontal_sweeps(cost, p)
    want = sgm.vertical_sweeps_wta_plain(cost, acc, p, margin)
    n = sgm.wta_launches
    got = sgm.vertical_sweeps_wta(cost, acc.clone(), p, margin)
    assert sgm.wta_launches == n + 1
    torch.cuda.synchronize(device)
    what = f"B3 at {(b, h, w, d)} min_d {min_d}, {paths} paths"
    if margin:
        (want, want_m), (got, got_m) = want, got
        assert torch.allclose(got_m, want_m, rtol=1e-6, atol=0.0), \
            f"{what}: margin differs"
    assert got.shape == (b, h, w) and got.dtype == torch.float32, what
    assert torch.equal(got >= min_d, want >= min_d), \
        f"{what}: validity differs"
    err = (got - want).abs().max().item()
    assert err <= 1e-5, f"{what}: max |err| {err}"
