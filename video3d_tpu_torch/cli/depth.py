"""CLI: stereo depth extraction on the PyTorch port.

``python -m video3d_tpu_torch.cli.depth <sbs.mp4> --work-dir WD
--max-frames N`` runs the CREStereo hybrid, the JAX CLI's default, on the
bundled weights (``video3d_tpu_torch/weights/crestereo_v1.safetensors``);
``--stereo-only`` runs the matcher alone, ``--guidance dpt --model <HF
safetensors dir>`` the DPT hybrid. Accepts the JAX CLI's flags
(``video3d_tpu.cli.depth``); those of features not yet ported (and
``--guidance mono``) exit with "not yet ported" instead of being ignored.
``--device`` defaults to ``cuda``; ``--device cpu`` is the only way onto
the CPU (the kernels' plain twins).
"""

from __future__ import annotations

import argparse
import sys

# flags of the JAX CLI whose features the port does not have yet
_NOT_PORTED = (
    "auto_range", "range_sample_frames", "auto_range_shots",
    "shot_threshold", "multihost", "coordinator", "num_processes",
    "process_id", "profile_dir",
)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="video-3d-depth-torch",
        description="Extract depth maps from a side-by-side 3D video "
                    "(PyTorch + CUDA port)",
    )
    p.add_argument("video", help="SBS stereoscopic video")
    p.add_argument("--work-dir", default="temp_depth")
    p.add_argument("--start-frame", type=int, default=0)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=None,
                   help="Frames per device batch (auto from memory if unset)")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the plain "
                        "twins of the kernels)")
    p.add_argument("--guidance", default=None,
                   choices=["none", "dpt", "crestereo", "mono"],
                   help="Guidance backend (default: crestereo unless "
                        "--stereo-only); 'mono' is not yet ported")
    p.add_argument("--stereo-only", action="store_true",
                   help="Disable neural guidance (reference depth.py:507)")
    p.add_argument("--no-neural", action="store_true",
                   help="Alias of --stereo-only")
    p.add_argument("--model", default="Intel/dpt-large",
                   help="Guidance checkpoint: the CREStereo weights file "
                        "(default: the bundled one) or a local HF DPT "
                        "directory with *.safetensors (none ships); a "
                        "failed load falls back to stereo-only")
    p.add_argument("--no-unsqueeze", action="store_true",
                   help="Skip the 2x anamorphic unsqueeze")
    p.add_argument("--per-frame-normalize", action="store_true",
                   help="Per-frame min-max normalisation (reference parity)")
    p.add_argument("--no-speckle", action="store_true",
                   help="Skip speckle filtering")
    p.add_argument("--fill-holes", action=argparse.BooleanOptionalAction,
                   default=None,
                   help="Background-extension fill of invalid pixels before "
                        "any guidance blend. Default: on with guidance, off "
                        "for stereo-only")
    p.add_argument("--guidance-weight", type=float, default=0.7,
                   help="Stereo weight of the fixed guidance blend")
    p.add_argument("--blend", default="confidence",
                   choices=("confidence", "fixed"),
                   help="Guidance mixing: 'confidence' (per-pixel, trust "
                        "gated) or 'fixed' (0.7/0.3)")
    p.add_argument("--trust-scale", type=int, default=1, choices=[1, 2, 4],
                   help="Resolution divisor of the guidance trust field")
    p.add_argument("--guidance-every", type=int, default=4,
                   help="Run the guidance on every Kth frame of a batch and "
                        "reuse it in between")
    p.add_argument("--temporal-smooth", default=None,
                   choices=("none", "median", "flow"),
                   help="Temporal depth filtering: 'median' = median-of-3, "
                        "'flow' = optical-flow-guided EMA")
    p.add_argument("--flow-scale", type=int, default=4, choices=(2, 4),
                   help="Flow-EMA guide reduction: 2 = finer motion edges "
                        "at ~4x flow cost; 4 = default")
    p.add_argument("--temporal-median", action="store_true",
                   help="Alias of --temporal-smooth median")
    p.add_argument("--force", action="store_true",
                   help="Recompute even if cached")
    for name in _NOT_PORTED:
        p.add_argument("--" + name.replace("_", "-"), dest=name,
                       nargs="?", const=True, default=None,
                       help=argparse.SUPPRESS)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    given = [n for n in _NOT_PORTED if getattr(args, n) is not None]
    if given:
        flags = ", ".join("--" + n.replace("_", "-") for n in given)
        print(f"not yet ported: {flags}", file=sys.stderr)
        return 2
    if args.guidance is not None:
        guidance = args.guidance
    elif args.stereo_only or args.no_neural:
        guidance = "none"
    else:
        guidance = "crestereo"  # the JAX CLI's default
    if guidance == "mono":
        print("not yet ported: guidance 'mono' (use --guidance crestereo, "
              "dpt or none)", file=sys.stderr)
        return 2

    from video3d_tpu_torch.stages.depth import StereoDepthExtractor

    extractor = StereoDepthExtractor(
        work_dir=args.work_dir,
        batch_size=args.batch_size,
        guidance=guidance,
        model_checkpoint=args.model,
        unsqueeze_anamorphic=not args.no_unsqueeze,
        normalize="per_frame" if args.per_frame_normalize else "fixed",
        apply_speckle=not args.no_speckle,
        temporal_median=args.temporal_median,
        temporal_smooth=args.temporal_smooth,
        flow_scale=args.flow_scale,
        stereo_weight=args.guidance_weight,
        blend=args.blend,
        fill_holes=args.fill_holes,
        guidance_every=args.guidance_every,
        trust_scale=args.trust_scale,
        device=args.device,
    )
    cache = extractor.process_video_sbs(
        args.video, start_frame=args.start_frame,
        max_frames=args.max_frames, force=args.force,
    )
    print(f"Depth maps: {cache}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
