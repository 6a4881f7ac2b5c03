"""The port's DPT vs the JAX (flax) DPT and the HF torch model.

The JAX package's tiny DPT params (random init, perturbed so that every
bias and scale is non-trivial) are carried across with
``jax_params_to_state_dict``; the same numpy pixels go to both forwards.
f32: rtol 1e-3, atol 2e-4, as tests/test_dpt.py holds the JAX model to HF.
bf16 (weights and input, as the stage runs it): both keep bf16 through the
backbone and neck and f32 after the first align-corners resize, but round
at other places (the attention's softmax, GELU and layer norm), so the
output is held to 3% of its range at most and 1% in the median.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from video3d_tpu.models import dpt as jdpt  # noqa: E402
from video3d_tpu_torch.kernels import attention  # noqa: E402
from video3d_tpu_torch.models import dpt as tdpt  # noqa: E402


def _jax_apply(params, x):
    """The JAX model's forward, jitted (eager flax dispatch is slow)."""
    return np.asarray(jax.jit(jdpt.DPTDepthModel(jdpt.DPTConfig.tiny()).apply)(
        params, x))


def _jax_params(seed=0):
    cfg = jdpt.DPTConfig.tiny()
    params = jax.jit(jdpt.DPTDepthModel(cfg).init)(
        jax.random.PRNGKey(seed), jnp.zeros((1, 64, 64, 3)))
    leaves, tree = jax.tree_util.tree_flatten(params)
    r = np.random.default_rng(seed)
    leaves = [np.asarray(a) + r.normal(0, 0.05, np.shape(a)).astype(np.float32)
              for a in leaves]
    return jax.tree_util.tree_unflatten(tree, leaves)


def _port_model(params, dtype=torch.float32):
    cfg = tdpt.DPTConfig.tiny()
    model = tdpt.DPTDepthModel(cfg)
    model.load_state_dict(tdpt.jax_params_to_state_dict(params, cfg))
    return model.to(dtype).eval().requires_grad_(False)


@pytest.fixture(scope="module")
def jax_params():
    return _jax_params()


@pytest.mark.parametrize("n_in,n_out", [(4, 8), (12, 24), (24, 37), (1, 5),
                                        (6, 1), (37, 37)])
def test_ac_matrix_equal(n_in, n_out):
    np.testing.assert_array_equal(tdpt._ac_matrix(n_in, n_out),
                                  jdpt._ac_matrix(n_in, n_out))


def test_config_matches_jax():
    for a, b in ((tdpt.DPTConfig.dpt_large(), jdpt.DPTConfig.dpt_large()),
                 (tdpt.DPTConfig.tiny(), jdpt.DPTConfig.tiny())):
        assert tuple(vars(a).items()) == tuple(vars(b).items())


@pytest.mark.parametrize("hw", [(64, 64), (48, 80)])
def test_forward_f32_matches_jax(jax_params, hw):
    """(64, 64) is the trained grid; (48, 80) interpolates the position
    embeddings (a 3x5 patch grid; the stride-32 stage rounds it up, so the
    output is 64x96 in both)."""
    x = np.random.default_rng(1).normal(size=(2, *hw, 3)).astype(np.float32)
    want = _jax_apply(jax_params, jnp.asarray(x))
    got = _port_model(jax_params)(torch.from_numpy(x))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=2e-4)


def test_forward_bf16_matches_jax(jax_params):
    x = np.random.default_rng(2).normal(size=(2, 64, 64, 3)).astype(np.float32)
    pb = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16),
                      jax_params)
    want = _jax_apply(pb, jnp.asarray(x).astype(jnp.bfloat16))
    got = _port_model(jax_params, torch.bfloat16)(
        torch.from_numpy(x).to(torch.bfloat16))
    assert got.dtype == torch.float32  # lifted by the decoder's resizes
    err = np.abs(got.numpy() - want)
    span = np.abs(want).max()
    assert err.max() <= 0.03 * span, (err.max(), span)
    assert np.median(err) <= 0.01 * span


def test_make_guidance_fn_matches_jax(jax_params):
    frames = np.random.default_rng(3).uniform(
        0, 255, size=(2, 48, 96, 3)).astype(np.float32)
    jfn = jdpt.make_guidance_fn(jdpt.DPTDepthModel(jdpt.DPTConfig.tiny()),
                                jax_params, infer_size=64)
    tfn = tdpt.make_guidance_fn(_port_model(jax_params), infer_size=64)
    want = np.asarray(jax.jit(jfn)(jnp.asarray(frames)))
    got = tfn(torch.from_numpy(frames))
    assert got.shape == want.shape == (2, 48, 96)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-3, atol=2e-4)
    assert attention.launches == 0  # CPU tensors: the twin, no launch


def _hf_tiny(seed):
    cfg = tdpt.DPTConfig.tiny()
    hf_cfg = transformers.DPTConfig(
        image_size=cfg.image_size, patch_size=cfg.patch_size,
        num_channels=3, hidden_size=cfg.hidden_size,
        num_hidden_layers=cfg.num_hidden_layers,
        num_attention_heads=cfg.num_attention_heads,
        intermediate_size=cfg.intermediate_size,
        backbone_out_indices=list(cfg.backbone_out_indices),
        neck_hidden_sizes=list(cfg.neck_hidden_sizes),
        readout_type=cfg.readout_type,
        fusion_hidden_size=cfg.fusion_hidden_size, is_hybrid=False)
    torch.manual_seed(seed)
    return transformers.DPTForDepthEstimation(hf_cfg).eval()


def test_load_dpt_safetensors_matches_hf_and_jax(tmp_path):
    tmodel = _hf_tiny(seed=3)
    tmodel.save_pretrained(tmp_path, safe_serialization=True)
    fn = tdpt.load_dpt_safetensors(str(tmp_path), dtype=torch.float32,
                                   infer_size=64, device="cpu")
    # the network alone against HF's predicted_depth
    x = np.random.default_rng(4).normal(size=(2, 64, 64, 3)).astype(
        np.float32)
    with torch.no_grad():
        ref = tmodel(pixel_values=torch.from_numpy(
            x.transpose(0, 3, 1, 2))).predicted_depth.numpy()
    got = fn.module(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-3, atol=2e-4)
    # the guidance fn against the JAX loader on the same directory
    jfn = jdpt.load_dpt_safetensors(str(tmp_path), dtype=np.float32,
                                    infer_size=64)
    frames = np.random.default_rng(5).uniform(
        0, 255, size=(1, 40, 64, 3)).astype(np.float32)
    np.testing.assert_allclose(fn(torch.from_numpy(frames)).numpy(),
                               np.asarray(jax.jit(jfn)(jnp.asarray(frames))),
                               rtol=1e-3, atol=2e-4)
    # load_dpt_guidance prefers the safetensors directory; bf16 by default
    gfn = tdpt.load_dpt_guidance(str(tmp_path), infer_size=64, device="cpu")
    assert next(gfn.module.parameters()).dtype == torch.bfloat16
    out = gfn(torch.from_numpy(frames))
    assert out.shape == (1, 40, 64) and torch.isfinite(out).all()


def test_load_dpt_guidance_from_a_torch_checkpoint(tmp_path):
    """A directory without safetensors goes through transformers
    (``local_files_only``), with the same weights and outputs."""
    tmodel = _hf_tiny(seed=4)
    tmodel.save_pretrained(tmp_path, safe_serialization=False)
    assert not list(tmp_path.glob("*.safetensors"))
    fn = tdpt.load_dpt_guidance(str(tmp_path), dtype=torch.float32,
                                infer_size=64, device="cpu")
    x = np.random.default_rng(7).normal(size=(1, 64, 64, 3)).astype(
        np.float32)
    with torch.no_grad():
        ref = tmodel(pixel_values=torch.from_numpy(
            x.transpose(0, 3, 1, 2))).predicted_depth.numpy()
    np.testing.assert_allclose(fn.module(torch.from_numpy(x)).numpy(), ref,
                               rtol=1e-3, atol=2e-4)


def test_load_dpt_guidance_raises_without_checkpoint(tmp_path):
    with pytest.raises(Exception) as err:
        tdpt.load_dpt_guidance(str(tmp_path / "missing"), device="cpu")
    assert "CUDA" not in str(err.value)  # the checkpoint, not the device


@pytest.mark.parametrize("load", ["random", "safetensors", "guidance"])
def test_dpt_loaders_default_to_cuda(tmp_path, monkeypatch, load):
    """With no device the loaders put the model on ``cuda``, and raise
    where CUDA is missing: nothing falls back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "random": lambda: tdpt.random_dpt_guidance(tdpt.DPTConfig.tiny()),
        "safetensors": lambda: tdpt.load_dpt_safetensors(str(tmp_path)),
        "guidance": lambda: tdpt.load_dpt_guidance(str(tmp_path)),
    }
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        calls[load]()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tdpt._loader_device(None, load) == torch.device("cuda")


def test_random_dpt_guidance_is_seeded(jax_params):
    cfg = tdpt.DPTConfig.tiny()
    frames = torch.from_numpy(np.random.default_rng(6).uniform(
        0, 255, size=(2, 32, 48, 3)).astype(np.float32))
    a = tdpt.random_dpt_guidance(cfg, seed=0, infer_size=64,
                                 device="cpu")
    b = tdpt.random_dpt_guidance(cfg, seed=0, infer_size=64,
                                 device="cpu")
    c = tdpt.random_dpt_guidance(cfg, seed=1, infer_size=64,
                                 device="cpu")
    assert next(a.module.parameters()).dtype == torch.bfloat16
    oa, ob, oc = a(frames), b(frames), c(frames)
    assert oa.shape == (2, 32, 48) and torch.isfinite(oa).all()
    assert torch.equal(oa, ob) and not torch.equal(oa, oc)
    n_params = sum(p.numel() for p in a.module.parameters())
    assert n_params == sum(np.size(x)
                           for x in jax.tree_util.tree_leaves(jax_params))
