"""Stereo depth extraction stage (counterpart of video3d_tpu.stages.depth).

Per batch, on one device: SBS split, 2x Lanczos-4 unsqueeze and BT.601
gray (one CUDA kernel on a card, :mod:`video3d_tpu_torch.kernels.image`),
the semi-global matcher (:func:`video3d_tpu_torch.ops.stereo.
sgbm_disparity` in any of its modes and horizontal routes, whose kernels
run on a CUDA device), the optional background-extension hole fill and
the optional neural guidance blend (kernels F1 and F2 on a card,
:mod:`video3d_tpu_torch.kernels.blend`), clamp of invalid pixels to 0,
fixed-range or per-frame normalisation, uint16 out. Host I/O -- decode, PNG16
writing, cache keys -- is the port's own :mod:`video3d_tpu_torch.core`.

Guidance, on every Kth frame of a batch: ``guidance='crestereo'`` (the
default) runs the CREStereo-lite matcher on both eyes
(:mod:`video3d_tpu_torch.models.crestereo`, the bundled weights), whose
disparity is mixed in as it is; ``guidance='dpt'`` runs DPT-large
monocular depth (:mod:`video3d_tpu_torch.models.dpt`, attention kernel
B7), min-max normalised and SSI-aligned onto the confident stereo. Both
mix by :func:`confidence_trust_blend` (or the fixed 0.7/0.3 blend). The
mono backend is not yet ported.

Temporal smoothing (``temporal_smooth``): ``median`` runs the median-of-3
along the frame axis, ``flow`` the flow-guided EMA on a 1/``flow_scale``
gray guide of the left eye (:mod:`video3d_tpu_torch.parallel.temporal`,
kernels B5 and B6). The sharded/fan-out variants are not yet ported.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from video3d_tpu_torch.core import (DepthMapWriter, VideoReader,
                                    create_work_directory, depth_cache_dir,
                                    get_video_info, is_depth_cached_range)
from video3d_tpu_torch.core.trace import span
from video3d_tpu_torch.kernels import blend as blend_kernel
from video3d_tpu_torch.kernels import image as image_kernel
from video3d_tpu_torch.models.crestereo import (BUNDLED_WEIGHTS,
                                                load_crestereo_guidance)
from video3d_tpu_torch.models.mono import ssi_align
from video3d_tpu_torch.ops.boxsum import box_sum_2d
from video3d_tpu_torch.ops.flow import FlowEMAParams
from video3d_tpu_torch.ops.image import resize2d
from video3d_tpu_torch.ops.stereo import (HORIZONTAL_ROUTES, SGBMParams,
                                          acc_dtype_for_params,
                                          sgbm_disparity)
from video3d_tpu_torch.parallel.temporal import (TemporalFlowEMAStream,
                                                 TemporalMedianStream)

# Same numeric contract as the JAX stage's ALGO_VERSION 2 (int16 cost,
# 5-path MODE_SGBM); the cache key adds BACKEND so the two never alias.
ALGO_VERSION = 2
BACKEND = "torch"

# Guidance blend weight of the stereo map (reference depth.py:358-363).
STEREO_WEIGHT = 0.7


def confidence_trust_blend(disp: torch.Tensor, margin: torch.Tensor,
                           guide: torch.Tensor, *,
                           min_disparity: float = 0.0,
                           trust_scale: int = 1) -> torch.Tensor:
    """Confidence-weighted stereo/guidance mixing (JAX
    ``confidence_trust_blend``), (B, H, W) each.

    The stereo weight per pixel is the texture-gated uniqueness margin;
    low-confidence pixels go to the guide only where the guide agrees
    (within 2 px) with the nearby confident stereo: a local trust ratio
    of agreeing to confident mass in an r = 8 box, falling back to the
    frame's ratio where the box holds under 2% confident mass, and to
    full trust where the frame holds under 32. ``trust_scale`` in {1, 2, 4}
    computes the trust field on an s-pooled grid (box r/s) and expands
    the ratio bilinearly.
    """
    conf = torch.where(disp > min_disparity - 0.5, margin, 0.0)
    stereo_pos = torch.clamp(disp, min=0.0)
    agree = torch.where((guide - stereo_pos).abs() <= 2.0, conf, 0.0)
    dims = (-2, -1)
    conf_mass = conf.sum(dim=dims, keepdim=True)
    q_frame = torch.where(
        conf_mass >= 32.0,  # else: nothing to judge -> trust
        agree.sum(dim=dims, keepdim=True) / torch.clamp(conf_mass, min=1e-6),
        1.0)
    r_t = 8
    if trust_scale > 1:
        s = int(trust_scale)
        bb, hh, ww = agree.shape
        hq, wq = hh // s, ww // s

        def pool(a):
            return a[:, :hq * s, :wq * s].reshape(bb, hq, s, wq,
                                                  s).sum(dim=(2, 4))

        r = max(1, r_t // s)
        num = box_sum_2d(pool(agree), r)
        den = box_sum_2d(pool(conf), r)
        area = box_sum_2d(torch.full((bb, hq, wq), float(s * s),
                                     device=conf.device), r)
        trust_q = torch.where(den > 0.02 * area,
                              num / torch.clamp(den, min=1e-6), q_frame)
        trust = resize2d(trust_q, hh, ww, method="bilinear")
    else:
        num = box_sum_2d(agree, r_t)
        den = box_sum_2d(conf, r_t)
        area = box_sum_2d(torch.ones_like(conf), r_t)
        trust = torch.where(den > 0.02 * area,
                            num / torch.clamp(den, min=1e-6), q_frame)
    conf = 1.0 - (1.0 - conf) * torch.clamp(trust, 0.0, 1.0)
    return conf * stereo_pos + (1.0 - conf) * guide


def guidance_blend(disp: torch.Tensor, margin: Optional[torch.Tensor],
                   left: torch.Tensor, right: torch.Tensor,
                   guidance_fn: Callable, params: SGBMParams,
                   guidance_every: int = 1,
                   stereo_weight: float = STEREO_WEIGHT,
                   blend: str = "confidence",
                   trust_scale: int = 1) -> torch.Tensor:
    """Mix the stereo disparity (B, H, W') with the guidance backend's
    output on the RGB eyes (B, H, W', 3) f32.

    Keyframe guidance: the backend runs on every ``guidance_every``-th
    frame of the batch (``x[::K]``) and each output serves the K frames
    from its own on; the cadence restarts at each batch. Stereo guidance
    (``fn.stereo``) is disparity already; mono output is min-max
    normalised to [0, num_disparities] and, with ``blend='confidence'``,
    SSI-aligned onto the confident stereo (kept where the fit has s > 0).
    ``confidence`` mixes by :func:`confidence_trust_blend` (``margin`` is
    the matcher's confidence); ``fixed`` is
    ``stereo_weight * disp + (1 - stereo_weight) * guide``.

    On a card the confidence blend at ``trust_scale`` 1 runs in kernels F1
    and F2 (:func:`video3d_tpu_torch.kernels.blend.trust_blend`), which
    read keyframe i // K for frame i; :func:`blend_plain` is their twin,
    and the path of ``fixed`` and of ``trust_scale`` 2 and 4. The span
    ``stage.blend`` counts the frames that went through the kernels
    (``fused``).
    """
    kev = max(1, int(guidance_every))
    b = left.shape[0]
    stereo = getattr(guidance_fn, "stereo", False)
    with span("guide.forward", left, keyframes=-(-b // kev)):
        out = guidance_fn(*(e[::kev] for e in
                            ((left, right) if stereo else (left,))))
    fused = b if (disp.is_cuda and blend == "confidence"
                  and trust_scale == 1) else 0
    with span("stage.blend", left, fused=fused):
        if fused:
            return blend_kernel.trust_blend(
                disp, margin, out, kev, stereo, params.num_disparities,
                float(params.min_disparity))
        return blend_plain(disp, margin, out, kev, stereo, params,
                           stereo_weight, blend, trust_scale)


def blend_plain(disp: torch.Tensor, margin: Optional[torch.Tensor],
                out: torch.Tensor, every: int, stereo: bool,
                params: SGBMParams, stereo_weight: float = STEREO_WEIGHT,
                blend: str = "confidence",
                trust_scale: int = 1) -> torch.Tensor:
    """:func:`guidance_blend` after the guide's forward, in plain
    operations: the guide's output on the keyframes, ``out``
    (ceil(B / every), H, W), expanded to the batch of ``disp``, a
    monocular one landed, then mixed. The twin of kernels F1 and F2."""
    b = disp.shape[0]
    out = out.repeat_interleave(every, dim=0)[:b] if every > 1 else out
    if stereo:
        guide = out
    else:
        mono = out
        dims = (-2, -1)
        mmin = mono.amin(dim=dims, keepdim=True)
        mmax = mono.amax(dim=dims, keepdim=True)
        guide = ((mono - mmin) / torch.clamp(mmax - mmin, min=1e-6)
                 * float(params.num_disparities))
        if blend == "confidence":
            conf_w = torch.where(
                disp > float(params.min_disparity) - 0.5, margin, 0.0)
            s, t = ssi_align(mono, torch.clamp(disp, min=0.0), conf_w)
            g_ssi = torch.clamp(mono * s + t, 0.0,
                                float(params.num_disparities))
            guide = torch.where(s > 0.0, g_ssi, guide)
    if blend == "confidence":
        return confidence_trust_blend(
            disp, margin, guide,
            min_disparity=float(params.min_disparity),
            trust_scale=trust_scale)
    return stereo_weight * disp + (1.0 - stereo_weight) * guide


def host_copy_async(t: torch.Tensor):
    """(host tensor, event): ``t`` copied into pinned host memory without
    waiting, and the event to synchronize on before reading it; a CPU
    tensor is returned as it is, with no event."""
    if t.device.type != "cuda":
        return t, None
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record(torch.cuda.current_stream(t.device))
    return host, event


def disparity_to_uint16(disp: torch.Tensor, num_disparities: int,
                        normalize: str = "fixed") -> torch.Tensor:
    """Clamp invalid/negative to 0 (reference depth.py:374), normalise
    (fixed range 0..num_disparities, or per-frame min-max) to uint16."""
    disp = torch.clamp(disp, min=0.0)
    if normalize == "per_frame":
        dmin = disp.amin(dim=(-2, -1), keepdim=True)
        dmax = disp.amax(dim=(-2, -1), keepdim=True)
        scaled = (disp - dmin) / torch.clamp(dmax - dmin, min=1e-6) * 65535.0
    else:
        scaled = disp * (65535.0 / float(num_disparities))
    # float -> integer truncates toward zero, like .astype(jnp.uint16)
    return torch.clamp(scaled, 0.0, 65535.0).to(torch.int32).to(torch.uint16)


def depth_batch_pipeline(
    frames: torch.Tensor,
    params: SGBMParams = SGBMParams(),
    unsqueeze: bool = True,
    normalize: str = "fixed",
    apply_speckle: bool = True,
    return_guide: bool = False,
    guide_scale: int = 4,
    guidance_fn: Optional[Callable] = None,
    guidance_every: int = 1,
    stereo_weight: float = STEREO_WEIGHT,
    blend: str = "confidence",
    fill_holes: bool = False,
    trust_scale: int = 1,
    horizontal_route: str = "legacy",
):
    """uint8 SBS RGB batch (B, H, W, 3) -> uint16 depth batch (B, H, W').

    W' is W (unsqueezed anamorphic) or W//2. Runs on ``frames.device``.
    ``params.num_paths`` picks the matcher's mode (2, 4, 5 or 8 paths) and
    ``horizontal_route`` (legacy|xla|mxu) the layout of its horizontal
    sweeps, with equal results (:func:`sgbm_disparity`).
    ``return_guide``: also return the bilinear 1/``guide_scale`` gray of
    the left eye, (B, ceil(H/s), ceil(W'/s)) f32 -- the motion guide of
    the flow smoother.

    ``fill_holes``: background-extension fill of invalid pixels before
    any blend. ``guidance_fn``: maps the f32 RGB left eye (B, H, W', 3) in
    [0, 255] (and the right eye when ``guidance_fn.stereo``) to relative
    depth (B, H, W'), mixed in by :func:`guidance_blend` with
    ``guidance_every``, ``stereo_weight``, ``blend`` (confidence|fixed)
    and ``trust_scale``.

    Each call is a ``stage`` span with a child span a step
    (:mod:`video3d_tpu_torch.core.trace`; recorded only under a profiler).
    """
    with span("stage", frames, frames=frames.shape[0]):
        with span("stage.eyes", frames):
            # the RGB eyes only for a guide
            gl, gr, left, right = image_kernel.eyes_gray(
                frames, unsqueeze, want_rgb=guidance_fn is not None)
        want_margin = guidance_fn is not None and blend == "confidence"
        with span("stage.matcher", frames):
            res = sgbm_disparity(gl, gr, params, apply_speckle=apply_speckle,
                                 return_margin=want_margin,
                                 horizontal_route=horizontal_route)
        disp, margin = res if want_margin else (res, None)
        if fill_holes:
            # before the blend: the margin at former holes stays ~0, so
            # the guidance still owns them
            with span("stage.fill", frames):
                disp = blend_kernel.fill_holes(
                    disp, float(params.min_disparity - 1))
        if guidance_fn is not None:
            with span("stage.guidance", frames):
                disp = guidance_blend(
                    disp, margin, left, right, guidance_fn, params,
                    guidance_every=guidance_every,
                    stereo_weight=stereo_weight, blend=blend,
                    trust_scale=trust_scale)
        with span("stage.quantize", frames):
            out = disparity_to_uint16(disp, params.num_disparities,
                                      normalize)
        if not return_guide:
            return out
        with span("stage.guide_out", frames):
            h, w = gl.shape[-2], gl.shape[-1]
            s = int(guide_scale)
            return out, resize2d(gl, -(-h // s), -(-w // s),
                                 method="bilinear")


class StereoDepthExtractor:
    """Stereo depth from SBS video on a torch device, with CREStereo (the
    default) or DPT guidance, or none."""

    def __init__(
        self,
        work_dir: str = "temp_depth",
        batch_size: Optional[int] = None,
        guidance: str = "crestereo",
        model_checkpoint: str = "Intel/dpt-large",
        unsqueeze_anamorphic: bool = True,
        normalize: str = "fixed",
        apply_speckle: bool = True,
        temporal_median: bool = False,
        temporal_smooth: Optional[str] = None,
        flow_scale: int = 4,
        stereo_weight: float = STEREO_WEIGHT,
        blend: str = "confidence",
        fill_holes: Optional[bool] = None,
        guidance_every: int = 4,
        trust_scale: int = 1,
        params: SGBMParams = SGBMParams(),
        horizontal_route: str = "legacy",
        device=None,
    ):
        """``device`` None means ``cuda``, which must be available; the
        plain twins run only when ``device="cpu"`` is asked for.
        ``temporal_smooth``: none|median|flow (``temporal_median=True``
        spells median); ``flow_scale`` 2 or 4 is the guide's reduction.
        ``guidance``: crestereo (default)|dpt|none|stereo_only;
        ``model_checkpoint`` is the CREStereo weights file (its default
        ``Intel/dpt-large``, the CLI's, resolves to the bundled
        ``weights/crestereo_v1.safetensors``) or the local DPT checkpoint
        (an HF safetensors directory); a guidance model that fails to
        load falls back to stereo-only with a warning.
        ``guidance_every`` K runs the guidance on every Kth frame (K=4,
        the JAX default), ``blend`` confidence|fixed (``stereo_weight`` is
        the fixed blend's), ``trust_scale`` 1|2|4, ``fill_holes`` None =
        on exactly when guidance is active. ``params.num_paths`` 2, 4, 5
        (default, MODE_SGBM) or 8 (MODE_HH) picks the matcher's mode;
        ``horizontal_route`` legacy|xla|mxu the layout of its horizontal
        sweeps (the same maps, so not part of the cache key)."""
        if guidance == "mono":
            raise NotImplementedError(
                "guidance='mono' is not yet ported (crestereo|dpt|none)")
        if guidance not in ("none", "stereo_only", "dpt", "crestereo"):
            raise ValueError(f"Unknown guidance backend: {guidance}")
        if normalize not in ("fixed", "per_frame"):
            raise ValueError(f"normalize must be fixed|per_frame: {normalize}")
        self.work_dir = create_work_directory(work_dir)
        self.batch_size = batch_size
        self.guidance = guidance
        # the CLI's --model default names the DPT checkpoint; the
        # crestereo backend resolves it to the bundled weights file, as
        # the JAX stage resolves it to crestereo_ckpt/
        if guidance == "crestereo" and model_checkpoint == "Intel/dpt-large":
            model_checkpoint = str(BUNDLED_WEIGHTS)
        self.model_checkpoint = (model_checkpoint
                                 if guidance in ("dpt", "crestereo")
                                 else "stereo_only")
        self.unsqueeze_anamorphic = bool(unsqueeze_anamorphic)
        self.normalize = normalize
        self.apply_speckle = bool(apply_speckle)
        if temporal_smooth is None:
            temporal_smooth = "median" if temporal_median else "none"
        if temporal_smooth not in ("none", "median", "flow"):
            raise ValueError(
                f"temporal_smooth must be none|median|flow: {temporal_smooth}")
        self.temporal_smooth = temporal_smooth
        if flow_scale not in (2, 4):
            raise ValueError(f"flow_scale must be 2 or 4: {flow_scale}")
        self.flow_scale = int(flow_scale)
        self.stereo_weight = float(stereo_weight)
        if blend not in ("confidence", "fixed"):
            raise ValueError(f"blend must be confidence|fixed: {blend}")
        self.blend = blend
        self.fill_holes = fill_holes
        if guidance_every < 1:
            raise ValueError(f"guidance_every must be >= 1: {guidance_every}")
        self.guidance_every = int(guidance_every)
        if trust_scale not in (1, 2, 4):
            raise ValueError(f"trust_scale must be 1, 2 or 4: {trust_scale}")
        self.trust_scale = int(trust_scale)
        self.params = params
        if horizontal_route not in HORIZONTAL_ROUTES:
            raise ValueError(f"horizontal_route must be one of "
                             f"{HORIZONTAL_ROUTES}: {horizontal_route}")
        self.horizontal_route = horizontal_route
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "StereoDepthExtractor: CUDA is not available; pass "
                "device=\"cpu\" (CLI: --device cpu) to run the plain twins")
        self._guidance_fn: Optional[Callable] = None
        self._guidance_loaded = False

    @property
    def fill_holes(self) -> bool:
        """Background-extension hole fill, AUTO by default: on whenever a
        guidance model is active, off for stereo-only (holes ship as 0,
        reference depth.py:374). Explicit True/False overrides; a
        guidance load that falls back to stereo-only also turns the auto
        fill off."""
        if self._fill_holes_opt is not None:
            return self._fill_holes_opt
        return self.guidance not in ("none", "stereo_only")

    @fill_holes.setter
    def fill_holes(self, v) -> None:
        self._fill_holes_opt = None if v is None else bool(v)

    def load_model(self) -> None:
        """Resolve the guidance backend once (reference depth.py:60-114).

        A failure degrades to stereo-only with a warning, the reference's
        soft-fallback contract (depth.py:107-114).
        """
        if self._guidance_loaded:
            return
        self._guidance_loaded = True
        if self.guidance in ("none", "stereo_only"):
            return
        try:
            if self.guidance == "crestereo":
                self._guidance_fn = load_crestereo_guidance(
                    self.model_checkpoint, device=self.device)
            else:
                from video3d_tpu_torch.models.dpt import load_dpt_guidance

                self._guidance_fn = load_dpt_guidance(self.model_checkpoint,
                                                      device=self.device)
            print(f"Guidance model loaded: {self.guidance}")
        except Exception as e:  # noqa: BLE001 -- degrade like the reference
            print(f"Warning: guidance load failed ({e}); using stereo only")
            self.guidance = "none"
            self.model_checkpoint = "stereo_only"
            self._guidance_fn = None

    def _auto_batch_size(self, height: int, width: int) -> int:
        """Frames per batch from free device memory.

        The live set peaks in the sweeps: the int16 cost volume and the
        accumulator (int16, or f32 for 8 paths), H*W'*D each, plus the
        uploaded frames and maps; 1.5x headroom over (2 + acc + 2) bytes
        per volume element, capped at 8 (the JAX stage's cap). A CPU device
        assumes 16 GiB, as the JAX stage does without memory stats.
        """
        if self.device.type == "cuda":
            free, _ = torch.cuda.mem_get_info(self.device)
        else:
            free = 16 * 2**30
        w_eye = width // 2 * (2 if self.unsqueeze_anamorphic else 1)
        vol = height * w_eye * self.params.num_disparities
        acc = acc_dtype_for_params(torch.int16, self.params).itemsize
        per_frame = int((2 + acc + 2) * vol * 1.5)
        return min(max(1, int(free * 0.75 / per_frame)), 8)

    def _model_key(self) -> str:
        """Cache-key component covering every output-affecting option,
        tagged with the backend so port and JAX maps never alias. The
        guidance tags read the resolved guidance: call it after
        :meth:`load_model`."""
        key = f"{self.model_checkpoint}+a{ALGO_VERSION}"
        if self.normalize != "fixed":
            key += f"+norm={self.normalize}"
        if self.temporal_smooth == "median":
            key += "+tmedian"
        elif self.temporal_smooth == "flow":
            key += "+tflow"
            if self.flow_scale != 4:
                key += f"@{self.flow_scale}"
        if not self.apply_speckle:
            key += "+nospeckle"
        guided = self.guidance not in ("none", "stereo_only")
        if self.stereo_weight != STEREO_WEIGHT:
            key += f"+sw={self.stereo_weight:g}"
        if guided and self.blend == "confidence":
            key += "+blend=conf"
        if self.fill_holes:
            key += "+fill"
        if guided and self.guidance_every != 1:
            key += f"+gev{self.guidance_every}"
        default = SGBMParams()
        if self.params != default:
            diff = ",".join(
                f"{f.name}={getattr(self.params, f.name)}"
                for f in dataclasses.fields(SGBMParams)
                if getattr(self.params, f.name) != getattr(default, f.name)
            )
            key += f"+sgbm({diff})"
        # the trust gate's scale changes the confidence blend's maps (the
        # JAX key lacks this tag)
        if guided and self.blend == "confidence" and self.trust_scale != 1:
            key += f"+ts{self.trust_scale}"
        return key + f"+{BACKEND}"

    def _smoother(self):
        """A fresh temporal smoother for one run, or None."""
        if self.temporal_smooth == "median":
            return TemporalMedianStream()
        if self.temporal_smooth == "flow":
            # one extra pyramid level at flow_scale 2 keeps the coarsest
            # level at the same absolute resolution as the default
            return TemporalFlowEMAStream(FlowEMAParams(
                levels=3 + (self.flow_scale == 2)))
        return None

    def _run_batches(self, batches: Iterable, cache: Path) -> int:
        """Upload, run, smooth and write ``(frames uint8 (B, H, W, 3),
        valid)`` batches into ``cache``; returns the number of frames read.

        Each batch's ``depth[:valid]`` (and guide) goes through the
        temporal smoother, whose output is written at the indices it
        emits: the median lags one batch and ends with ``flush()``. One
        batch in flight: a batch's maps are copied to the host
        asynchronously and handed to the PNG writer while the next runs.
        The guidance model is resolved first (:meth:`load_model`). The
        upload, smoothing, readback and write are ``extract.*`` spans
        (:mod:`video3d_tpu_torch.core.trace`).
        """
        self.load_model()
        cuda = self.device.type == "cuda"
        smoother = self._smoother()
        want_guide = self.temporal_smooth == "flow"
        done = 0
        written = 0
        pending = None  # (host maps, copy-done event, start index, count)
        t0 = time.time()
        with DepthMapWriter(cache) as writer:

            def drain(p):
                host, event, start, n_valid = p
                with span("extract.write", self.device):
                    if event is not None:
                        event.synchronize()
                    writer.put(host.numpy(), start, n_valid)

            def stage(maps, start, n_valid):
                nonlocal pending
                with span("extract.readback", self.device):
                    host, event = host_copy_async(maps)
                if pending is not None:
                    drain(pending)
                pending = (host, event, start, n_valid)

            for frames, valid in batches:
                with span("extract.upload", self.device):
                    x = torch.from_numpy(np.ascontiguousarray(frames))
                    if cuda:
                        x = x.pin_memory()
                    x = x.to(self.device, non_blocking=cuda)
                depth = depth_batch_pipeline(
                    x, params=self.params,
                    unsqueeze=self.unsqueeze_anamorphic,
                    normalize=self.normalize,
                    apply_speckle=self.apply_speckle,
                    return_guide=want_guide,
                    guide_scale=self.flow_scale,
                    guidance_fn=self._guidance_fn,
                    guidance_every=self.guidance_every,
                    stereo_weight=self.stereo_weight,
                    blend=self.blend,
                    fill_holes=self.fill_holes,
                    trust_scale=self.trust_scale,
                    horizontal_route=self.horizontal_route,
                )
                if want_guide:
                    depth, guide = depth
                if smoother is None:
                    stage(depth, done, valid)
                else:
                    with span("extract.smooth", self.device):
                        out = (smoother.push(depth[:valid], guide[:valid])
                               if want_guide
                               else smoother.push(depth[:valid]))
                    if out is not None:
                        stage(out, written, out.shape[0])
                        written += out.shape[0]
                done += valid
                if done % 100 < valid:
                    dt = time.time() - t0
                    print(f"  {done} frames ({done / max(dt, 1e-9):.1f} fps)")
            if smoother is not None:
                with span("extract.smooth", self.device):
                    out = smoother.flush()
                if out is not None:
                    stage(out, written, out.shape[0])
            if pending is not None:
                drain(pending)
        return done

    def process_video_sbs(
        self,
        video_path: str,
        start_frame: int = 0,
        max_frames: Optional[int] = None,
        force: bool = False,
    ) -> Path:
        """Extract depth maps for a frame range; returns the cache dir.

        Idempotent: a complete cache is returned as it is unless ``force``.
        The guidance is resolved before the cache key is made, so a
        guidance load that falls back to stereo-only never writes under
        the hybrid key (the JAX stage keys first: ROADMAP C2).
        """
        info = get_video_info(str(video_path))
        if info is None:
            raise RuntimeError(f"Cannot probe video: {video_path}")
        n_total = info["frames"] - start_frame if info["frames"] else None
        n_frames = (
            min(n_total, max_frames)
            if (n_total is not None and max_frames is not None)
            else (max_frames if max_frames is not None else n_total)
        )
        self.load_model()
        cache = depth_cache_dir(
            self.work_dir, str(video_path), start_frame,
            n_frames if n_frames is not None else "all",
            self._model_key(), self.unsqueeze_anamorphic,
        )
        if (not force and n_frames is not None
                and is_depth_cached_range(cache, 0, n_frames)):
            print(f"Using cached depth maps: {cache}")
            return cache
        batch = self.batch_size or self._auto_batch_size(
            info["height"], info["width"])
        print(f"Extracting depth: "
              f"{n_frames if n_frames is not None else '?'} frames, "
              f"batch={batch}, guidance={self.guidance}, device={self.device}")
        reader = VideoReader(str(video_path), start_frame=start_frame,
                             max_frames=n_frames, batch_size=batch)
        t0 = time.time()
        done = self._run_batches(reader, cache)
        dt = time.time() - t0
        print(f"Depth extraction done: {done} frames in {dt:.1f}s "
              f"({done / max(dt, 1e-9):.1f} fps) -> {cache}")
        return cache
