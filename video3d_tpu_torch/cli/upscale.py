"""CLI: depth upscale + encode on the PyTorch port.

``python -m video3d_tpu_torch.cli.upscale <depth_dir> <video_4k>
--work-dir WD`` upscales a depth PNG16 sequence to the 4K source's
geometry with the adaptive method (the default; ``--method guided`` is
the guided filter, ``--method scale`` a plain resize) and writes
``depth_4k_<dirname>_<method>[_<guide_mode>].mp4`` (``--png16-out``: a
PNG16 directory). Accepts the JAX CLI's flags (``video3d_tpu.cli.upscale``);
``--alignment-file`` needs the alignment stage, which is not yet ported,
and exits with "not yet ported" (``--guide-start-frame`` sets the offset
directly). ``--device`` defaults to ``cuda``; ``--device cpu`` is the only
way onto the CPU.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="video-3d-upscale-torch",
        description="Upscale a depth-map sequence to a 4K source's geometry "
                    "and encode (PyTorch + CUDA port)",
    )
    p.add_argument("depth_dir", help="Directory of depth_*.png maps")
    p.add_argument("video_4k", help="4K source (target geometry/fps + guide)")
    p.add_argument("--work-dir", default="temp_upscale")
    p.add_argument("--output", default=None,
                   help="Output path (default: depth_4k_<dirname>_<method>"
                        "[_<guide mode>].mp4)")
    p.add_argument("--method", choices=["guided", "adaptive", "scale"],
                   default="adaptive",
                   help="'adaptive' (default): per-pixel mix of the color "
                        "guided and the plain upsample by local depth/guide "
                        "edge agreement; 'guided': the edge-preserving "
                        "guided filter; 'scale': plain resize")
    p.add_argument("--guide-mode", choices=["gray", "color"], default="gray",
                   help="Guided-filter guide: luma (fast) or full RGB "
                        "covariance")
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--radius", type=int, default=8,
                   help="Guided-filter window radius")
    p.add_argument("--eps", type=float, default=1e-3,
                   help="Guided-filter regularization")
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--alignment-file", default=None,
                   help="alignment_data.json from video-3d-align (not yet "
                        "ported: use --guide-start-frame)")
    p.add_argument("--guide-start-frame", type=int, default=None,
                   help="4K guide frame paired with depth frame 0")
    p.add_argument("--png16-out", action="store_true",
                   help="Write a full-precision uint16 PNG sequence instead "
                        "of an 8-bit H.264 video")
    p.add_argument("--crf", type=int, default=18,
                   help="x264 rate factor (reference contract: 18)")
    p.add_argument("--preset", default="medium",
                   help="x264 preset (reference contract: medium)")
    p.add_argument("--encode-workers", type=int, default=1,
                   help="segment-parallel encoder threads")
    p.add_argument("--encode-threads", type=int, default=0,
                   help="x264 internal frame threads per encoder (0 = auto)")
    p.add_argument("--use-nvenc", action="store_true",
                   help="Accepted for parity; software encode")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs on the CPU)")
    p.add_argument("--force", action="store_true")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.alignment_file and args.guide_start_frame is None:
        print("not yet ported: --alignment-file (use --guide-start-frame)",
              file=sys.stderr)
        return 2

    from video3d_tpu_torch.stages.upscale import DepthUpscaler

    upscaler = DepthUpscaler(
        work_dir=args.work_dir,
        use_nvenc=args.use_nvenc,
        method=args.method,
        batch_size=args.batch_size,
        radius=args.radius,
        eps=args.eps,
        guide_mode=args.guide_mode,
        crf=args.crf,
        preset=args.preset,
        encode_workers=args.encode_workers,
        encode_threads=args.encode_threads,
        device=args.device,
    )
    out = upscaler.process_depth_upscaling(
        args.depth_dir,
        args.video_4k,
        output_path=args.output,
        force=args.force,
        max_frames=args.max_frames,
        png16_out=args.png16_out,
        guide_start_frame=args.guide_start_frame or 0,
    )
    print(f"Depth video: {out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
