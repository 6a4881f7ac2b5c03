"""Run one cell of the depth stage's benchmark once, on the card.

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. Loads, warms up, measures for ``--seconds``,
compares what the window produced with the reference, and prints one JSON
line last on standard output (``--trace 0``: the cell's end-to-end metrics;
``--trace 1``: its per-layer metrics and a breakdown). The compared numbers
and their limits are the last lines on standard error. Exits non-zero and
prints no result without a CUDA device (or fewer than the cell asks for),
or if ``jax``, ``jaxlib``, ``flax`` or ``video3d_tpu`` was imported.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "video3d_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is a forbidden one, whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # a library the port uses must not load JAX behind it
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_TF"] = "0"
    import torch

    from benchmark.harness import cell
    from benchmark.harness.registry import Registry

    def log(msg: str) -> None:
        print(msg, file=sys.stderr, flush=True)

    log(f"set-up {time.perf_counter() - T_START:.3f} s: torch imported")
    reg = Registry(ROOT)
    chips = reg.cell(args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f" visible")
        return 2
    import video3d_tpu_torch

    if Path(video3d_tpu_torch.__file__).resolve().parents[1] != ROOT:
        log(f"video3d_tpu_torch is not this checkout's: "
            f"{video3d_tpu_torch.__file__}")
        return 2
    out = cell.run(reg, args.workload, args.seed, args.seconds,
                   bool(args.trace), "cuda", T_START, log)
    bad = forbidden_modules()
    if bad:
        log(f"forbidden modules loaded: {', '.join(bad)}")
        return 3
    for name, row in out["checked"].items():
        log(f"{name} {row['value']!r} limit {row['limit']!r}")
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)  # the checkout, not benchmark/
    sys.exit(main())
