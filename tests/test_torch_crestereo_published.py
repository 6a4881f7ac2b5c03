"""The published CREStereo (``video3d_tpu_torch/models/crestereo_net.py``)
on the CPU at small widths, held part by part and whole to the plain
reference (``benchmark/reference/crestereo_published.py``) and to direct
evaluations of its equations, on weights the benchmark's guide kind draws
from a seed; and the loader's choice of network by the weights' names.

Tolerances: where port and reference compute in float32 they differ only
in the order of float32 sums (batched against per-sample calls, one
``grid_sample`` for nine points against nine, einsum against loops), which
moves a 60-step forward's disparity by about 3e-6 px at these sizes; 1e-4
is held. Explicit loops in float64 are held at 1e-5 (float32 products
against float64).
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import pytest
import torch

from benchmark.harness.registry import Registry
from benchmark.reference import crestereo_published as ref
from video3d_tpu_torch.models import crestereo as lite
from video3d_tpu_torch.models import crestereo_net as net
from video3d_tpu_torch.tools.card_checks import agcl_loop, agcl_points
from tests.tiny_window import one_thread  # noqa: F401 (a fixture)

# thousands of small ops beside other workers (tests/tiny_window.py)
pytestmark = pytest.mark.usefixtures("one_thread")


F32_TOL = 1e-4  # px, float32 sums in another order (module docstring)
LOOP_TOL = 1e-5  # float32 against float64 loops


def _guide(cfg: net.PublishedConfig, conv_dtype="float32") -> dict:
    g = {k: (list(v) if isinstance(v, tuple) else v)
         for k, v in dataclasses.asdict(cfg).items() if k != "dtype"}
    g.update(kind="crestereo_published", conv_dtype=conv_dtype,
             infer_scale_hd=2)
    return g


TINY = _guide(net.PublishedConfig.tiny())


@pytest.fixture(scope="module")
def kind():
    return Registry().guide("crestereo_published")


@pytest.fixture(scope="module")
def ckpt(kind, tmp_path_factory):
    return kind.weights(TINY, 2**31 + 11, tmp_path_factory.mktemp("pub"),
                        "cpu")


@pytest.fixture(scope="module")
def port(ckpt):
    """The float32 port through the loader."""
    return lite.load_crestereo_guidance(ckpt, dtype=torch.float32,
                                        device="cpu")


@pytest.fixture(scope="module")
def reference(kind, ckpt):
    return kind.reference(ckpt, TINY, "cpu", False)


def _pair(seed, b=2, h=64, w=128, shift=6):
    """Eyes (B, H, W, 3) f32 in [0, 255], the right the left shifted by
    ``shift`` px, of random 2-px squares."""
    r = np.random.default_rng(seed)
    base = r.integers(0, 256, (b, h // 2, (w + shift) // 2 + 1, 3))
    base = np.repeat(np.repeat(base, 2, 1), 2, 2).astype(np.float32)
    return (torch.from_numpy(np.ascontiguousarray(base[:, :, :w])),
            torch.from_numpy(np.ascontiguousarray(base[:, :, shift:shift
                                                       + w])))


def _nchw(e):
    return e.permute(0, 3, 1, 2).contiguous()


def test_encoder_matches_reference(port, reference):
    left, right = _pair(1)
    x = torch.cat([_nchw(left), _nchw(right)]) / 255.0 * 2.0 - 1.0
    with torch.no_grad():
        got = port.module.fnet(x)
        want = reference.encoder(x)
    assert got.shape == (4, TINY["feat_dim"], 16, 32)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def _direct_layer(layer: net.LoFTRLayer, x, src):
    """A LoFTR layer evaluated as written: per head the matrix phi(q_l) .
    phi(k_s) in float64, each row's values over its sum plus 1e-6, merge,
    layer norm, the MLP on [x, m], layer norm, the residual."""
    d = x.shape[-1]
    heads = layer.nhead
    w = {k: v.double() for k, v in layer.state_dict().items()}

    def phi(t):
        return torch.where(t > 0, t + 1.0, torch.exp(t))

    x64, s64 = x.double(), src.double()
    q = phi(x64 @ w["q_proj.weight"].T).unflatten(-1, (heads, d // heads))
    k = phi(s64 @ w["k_proj.weight"].T).unflatten(-1, (heads, d // heads))
    v = (s64 @ w["v_proj.weight"].T).unflatten(-1, (heads, d // heads))
    out = torch.zeros_like(q)
    for n, h in itertools.product(range(x.shape[0]), range(heads)):
        a = q[n, :, h] @ k[n, :, h].T  # (L, S)
        out[n, :, h] = (a @ v[n, :, h]) / (a.sum(-1, keepdim=True) + 1e-6)

    def ln(t, name):
        return torch.nn.functional.layer_norm(
            t, (d,), w[name + ".weight"], w[name + ".bias"], 1e-5)

    m = ln(out.flatten(-2) @ w["merge.weight"].T, "norm1")
    m = torch.relu(torch.cat([x64, m], -1) @ w["mlp.0.weight"].T)
    return x64 + ln(m @ w["mlp.2.weight"].T, "norm2")


@pytest.mark.parametrize("layer", ["self_att_fn.layers.0",
                                   "self_att_fn.layers.1",
                                   "cross_att_fn.layers.0"])
def test_linear_attention_layer_is_its_formula(port, reference, layer):
    """The port's layer and the reference's against the direct evaluation,
    self (source = x) and cross, source of another length."""
    mod = port.module.get_submodule(layer)
    g = torch.Generator().manual_seed(3)
    x = torch.randn(2, 12, TINY["d_model"], generator=g)
    src = x if "layers.0" in layer and "self" in layer else torch.randn(
        2, 7, TINY["d_model"], generator=g)
    want = _direct_layer(mod, x, src)
    with torch.no_grad():
        got = mod(x, src)
        ref_got = reference.attention_layer(x, src, layer)
    torch.testing.assert_close(got.double(), want, rtol=0, atol=LOOP_TOL)
    torch.testing.assert_close(ref_got.double(), want, rtol=0, atol=LOOP_TOL)


@pytest.mark.parametrize("small", [False, True], ids=["1x9", "3x3"])
@pytest.mark.parametrize("deformable", [True, False])
def test_agcl_is_its_point_loop(reference, small, deformable):
    """Both patterns, with learned offsets (1/16, 1/8) and warped (1/4),
    port and reference against the explicit loop: flows of a few pixels
    reach outside the frame, so the zero padding of the sampling and the
    replicate padding of the shifts are both read."""
    g = torch.Generator().manual_seed(5 + small + 2 * deformable)
    b, c, h, w, groups = 2, 8, 4, 6, 4
    f1 = torch.randn(b, c, h, w, generator=g)
    f2 = torch.randn(b, c, h, w, generator=g)
    flow = 3.0 * torch.randn(b, 2, h, w, generator=g)
    offset = (torch.rand(b, 18, h, w, generator=g) * 2.0 - 1.0
              if deformable else None)
    want = agcl_loop(f1, f2, flow, offset, small, groups)
    if deformable:
        got = net.agcl_deformable(f1, f2, flow, offset, small, groups)
    else:
        got = net.agcl_warped(f1, f2, flow, small, groups)
    torch.testing.assert_close(got.double(), want, rtol=0, atol=LOOP_TOL)
    assert TINY["groups"] == groups
    ref_got = torch.cat([reference.agcl(f1[i:i + 1], f2[i:i + 1],
                                        flow[i:i + 1], None if offset is None
                                        else offset[i:i + 1], small)
                         for i in range(b)])
    torch.testing.assert_close(ref_got.double(), want, rtol=0, atol=LOOP_TOL)


@pytest.mark.parametrize("small", [False, True], ids=["1x9", "3x3"])
@pytest.mark.parametrize("deformable", [True, False])
def test_agcl_wrapper_runs_the_twin_on_the_cpu(small, deformable):
    """``kernels/agcl.py correlate`` sends CPU tensors to the twin, which
    gives the same bits, and launches nothing; ``kernel_layout`` leaves a
    CPU tensor as it is."""
    from video3d_tpu_torch.kernels import agcl

    g = torch.Generator().manual_seed(9 + small + 2 * deformable)
    f1, f2 = (torch.randn(2, 128, 5, 7, generator=g) for _ in range(2))
    flow = 2.0 * torch.randn(2, 2, 5, 7, generator=g)
    offset = (torch.rand(2, 18, 5, 7, generator=g) * 2.0 - 1.0
              if deformable else None)
    assert all(agcl.kernel_layout(t) is t for t in (f1, f2, flow))
    n = agcl.launches
    got = agcl.correlate(f1, f2, flow, offset, small, 2)
    want = (net.agcl_deformable(f1, f2, flow, offset, small, 2) if deformable
            else net.agcl_warped(f1, f2, flow, small, 2))
    assert torch.equal(got, want) and agcl.launches == n


def test_convex_upsample_is_its_sum(reference):
    """Sub-pixel (i, j) of cell (y, x) mixes the 3x3 neighbours of 4 f,
    zero outside, by a softmax over mask channels k * 16 + i * 4 + j."""
    g = torch.Generator().manual_seed(9)
    b, h, w, rate = 2, 3, 4, 4
    flow = torch.randn(b, 2, h, w, generator=g)
    mask = torch.randn(b, 9 * rate * rate, h, w, generator=g)
    want = np.zeros((b, 2, rate * h, rate * w))
    f, m = flow.double().numpy(), mask.double().numpy()
    for n, y, x, i, j in itertools.product(range(b), range(h), range(w),
                                           range(rate), range(rate)):
        logits = np.array([m[n, k * 16 + i * 4 + j, y, x] for k in range(9)])
        wgt = np.exp(logits - logits.max())
        wgt /= wgt.sum()
        for k, (dx, dy) in enumerate(agcl_points(True)):
            if 0 <= y + dy < h and 0 <= x + dx < w:
                want[n, :, rate * y + i, rate * x + j] += (
                    wgt[k] * rate * f[n, :, y + dy, x + dx])
    got = net.convex_upsample(flow, mask, rate)
    torch.testing.assert_close(got.double(), torch.from_numpy(want), rtol=0,
                               atol=LOOP_TOL)
    torch.testing.assert_close(reference.upsample(flow, mask).double(),
                               torch.from_numpy(want), rtol=0, atol=LOOP_TOL)


def test_update_step_matches_reference(port, reference):
    """One step of the update block: hidden state, mask and flow delta."""
    g = torch.Generator().manual_seed(11)
    b, h, w = 2, 5, 7
    hid = torch.tanh(torch.randn(b, TINY["hidden_dim"], h, w, generator=g))
    inp = torch.relu(torch.randn(b, TINY["context_dim"], h, w, generator=g))
    corr = torch.randn(b, 36, h, w, generator=g)
    flow = torch.randn(b, 2, h, w, generator=g)
    with torch.no_grad():
        got = port.module.update_block(hid, inp, corr, flow, want_mask=True)
        want = reference.update(hid, inp, corr, flow)
    for a, e in zip(got, want):
        torch.testing.assert_close(a, e, rtol=0, atol=1e-5)


def test_sine_encoding_is_loftrs():
    pe = net.sine_encoding(32, 3, 5, "cpu")
    k, x, y = 3, 4, 2  # channel 4k.., column x (from 0), row y
    omega = np.exp(-2 * k * np.log(10000.0) / 16)
    np.testing.assert_allclose(
        pe[4 * k:4 * k + 4, y, x].numpy(),
        [np.sin((x + 1) * omega), np.cos((x + 1) * omega),
         np.sin((y + 1) * omega), np.cos((y + 1) * omega)], rtol=0,
        atol=1e-7)
    torch.testing.assert_close(pe, ref.sine_encoding(32, 3, 5))


def test_two_pass_forward_matches_reference(port, reference):
    """The whole guidance call (both passes, 60 steps) in float32."""
    left, right = _pair(2)
    got = port(left, right)
    want = reference.guidance(left.double(), right.double(), "f64")
    assert got.shape == (2, 64, 128) and got.dtype == torch.float32
    torch.testing.assert_close(got.double(), want, rtol=0, atol=F32_TOL)
    # not degenerate: the flow moved, and differs across the frame
    assert float(want.std()) > 0.3 and float(want.mean()) > 1.0


def test_bf16_is_nearer_than_fp8(kind, ckpt, reference):
    """The bf16 port against the float32 reference: bf16 rounds every
    convolution's and linear's operands (8 bits of mantissa) through 60
    recurrent steps; at these widths that moves the disparity by ~0.008 px
    in the mean and ~0.04 at most (3 seeds). The bounds, 0.03 and 0.2 px,
    lie below what one precision lower gives: the fp8 control (~0.09 in
    the mean) fails the first."""
    left, right = _pair(3)
    want = reference.guidance(left.double(), right.double(), "f64")
    fn = lite.load_crestereo_guidance(ckpt, dtype=torch.bfloat16,
                                      device="cpu")
    kind.check(fn, dict(TINY, conv_dtype="bfloat16"))
    err = (fn(left, right).double() - want).abs()
    assert float(err.mean()) <= 0.03 and float(err.max()) <= 0.2
    low = kind.reference(ckpt, TINY, "cpu", True).guidance(
        left.double(), right.double(), "f64")
    assert float((low - want).abs().mean()) > 0.03


def test_loader_picks_the_network_by_names(port, ckpt, tmp_path):
    """Published names build the published network at the file's widths;
    the bundled lite file builds CREStereoLite, whose outputs are those of
    the lite module loaded directly; a file of neither names fails to
    load."""
    assert type(port.module) is net.CREStereo and port.stereo
    assert port.module.cfg == net.PublishedConfig.tiny()
    fn = lite.load_crestereo_guidance(device="cpu", dtype=torch.float32)
    assert type(fn.module) is lite.CREStereoLite and fn.stereo
    model = lite.CREStereoLite(lite.CREStereoConfig())
    model.load_state_dict(lite.load_weights(lite.BUNDLED_WEIGHTS))
    left, right = _pair(4, h=32, w=96)
    with torch.no_grad():
        assert torch.equal(fn(left, right), model.eval()(left, right))
    from safetensors.torch import load_file, save_file

    half = {k: v for k, v in load_file(str(ckpt)).items()
            if not k.startswith("self_att_fn.")}
    save_file(half, str(tmp_path / "half.safetensors"))
    with pytest.raises(RuntimeError, match="state_dict"):
        lite.load_crestereo_guidance(tmp_path / "half.safetensors",
                                     device="cpu")


@pytest.mark.parametrize("hw, scale, want", [
    ((1080, 1920), 2, (544, 960)), ((720, 1280), 2, (352, 640)),
    ((719, 1280), 2, (704, 1280)), ((64, 128), 2, (64, 128)),
    ((40, 100), 2, (32, 96)), ((1080, 1920), 1, (1088, 1920)),
    ((10, 10), 2, (32, 32))])
def test_evaluation_size(hw, scale, want):
    """From 720 rows up 1/s, each side to the nearest multiple of 32
    (halves up, 32 at least); the reference's rule is the port's."""
    assert net.eval_shape(*hw, scale) == want
    assert ref.eval_shape(*hw, scale) == want


def test_keyframe_resize_and_width_scale(ckpt, monkeypatch):
    """A 1080p keyframe runs at 544x960 and its disparity comes back
    scaled by W / w_eval: a network that answers c px everywhere gives
    c * 1920 / 960 at every pixel of the eye."""
    seen = []

    def constant(self, left, right):
        seen.append(tuple(left.shape))
        return torch.full((left.shape[0], *left.shape[-2:]), 3.0)

    monkeypatch.setattr(net.CREStereo, "infer", constant)
    fn = lite.load_crestereo_guidance(ckpt, device="cpu")
    eye = torch.zeros(1, 1080, 1920, 3)
    out = fn(eye, eye)
    assert seen == [(1, 3, 544, 960)] and out.shape == (1, 1080, 1920)
    torch.testing.assert_close(out, torch.full_like(out, 6.0))


def test_spans_count_steps_and_calls(port):
    """Under a profile: ``guide.refine`` counts 60 steps a forward over
    its two spans (40 and 20), ``guide.agcl`` is one span a step with 20
    deformable calls and none through kernel A1 (``fused``: the CPU runs
    the twin), ``guide.encoder`` counts both eyes of each pass, and
    ``guide.transformer`` runs once."""
    from torch.profiler import ProfilerActivity, profile

    from video3d_tpu_torch.core import trace

    left, right = _pair(6)
    trace.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            port(left, right)
        table, recs = trace.summary(), trace.records()
    finally:
        trace.reset()
    assert [r["counts"]["steps"] for r in recs
            if r["name"] == "guide.refine"] == [40, 20]
    assert table["guide.agcl"]["count"] == 60
    assert table["guide.agcl"]["counts"] == {"deformable": 20, "fused": 0}
    assert all(recs[r["parent"]]["name"] == "guide.refine" for r in recs
               if r["name"] == "guide.agcl")
    assert table["guide.encoder"]["counts"] == {"images": 2 * 2 * 2}
    assert table["guide.transformer"]["count"] == 1


def test_conv_keeps_its_cast_kernel_until_the_weights_change():
    """The published network's conv casts its kernel once (channels-last)
    and again after the f32 weights change in place or are loaded anew;
    its output is the lite's cast-per-call conv's."""
    torch.manual_seed(0)
    conv = net.Conv2d(6, 4, (1, 5), dtype=torch.bfloat16)
    ref_conv = lite.Conv2d(6, 4, (1, 5), dtype=torch.bfloat16)
    ref_conv.load_state_dict(conv.state_dict())
    x = torch.randn(2, 6, 5, 7)
    assert torch.equal(conv(x), ref_conv(x))
    kernel = conv._cast[0]
    assert kernel.is_contiguous(memory_format=torch.channels_last)
    conv(x)
    assert conv._cast[0] is kernel
    with torch.no_grad():
        conv.weight.mul_(2.0)
    ref_conv.load_state_dict(conv.state_dict())
    assert torch.equal(conv(x), ref_conv(x)) and conv._cast[0] is not kernel
    conv.load_state_dict({k: v + 1.0 for k, v in conv.state_dict().items()})
    ref_conv.load_state_dict(conv.state_dict())
    assert torch.equal(conv(x), ref_conv(x))
