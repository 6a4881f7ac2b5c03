"""Readings that the correctness limits are set from (not part of a run).

    python3 benchmark/readings.py --workload <name> --seeds 1,2,3 \
        --seconds 3 [--control] [--tf32] [--out <file.jsonl>]

For each seed, in one process: a run of the cell with a short window (its
sampled batches compared with the reference, as every run compares them),
and with ``--control`` the reference put in the program's place one
precision lower (TF32 resampling, bfloat16 gray, fp8 guide convolutions)
on the same frames, compared with the reference the same way. ``--tf32``
runs the program with its float32 matrix products in TF32 (PyTorch's
``allow_tf32`` switch on; the reference turns it off for itself): the
readings of that fault. Prints one JSON line a seed: the program's
numbers, the control's, frames/s and set-up.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--tf32", action="store_true")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch

    from benchmark.harness import cell, check
    from benchmark.harness.registry import Registry

    if not torch.cuda.is_available():
        print("readings need a CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = args.tf32
    reg = Registry(ROOT)
    sink = open(args.out, "a") if args.out else None
    for seed in (int(s) for s in args.seeds.split(",")):
        keep = {}
        t0 = time.perf_counter()
        out = cell.run(reg, args.workload, seed, args.seconds, False, "cuda",
                       t0, lambda m: print(m, file=sys.stderr), keep)
        row = dict(workload=args.workload, seed=seed, tf32=args.tf32,
                   program={k: v["value"] for k, v in out["checked"].items()},
                   metrics={k: v["value"] for k, v in out["metrics"].items()})
        if args.control:
            t1 = time.perf_counter()
            row["control"] = check.control(keep, reg, "cuda")
            row["control_s"] = time.perf_counter() - t1
        row["seconds_total"] = time.perf_counter() - t0
        line = json.dumps(row)
        print(line, flush=True)
        if sink:
            sink.write(line + "\n")
            sink.flush()
        torch.cuda.empty_cache()
    if sink:
        sink.close()
    return 0


if __name__ == "__main__":
    sys.path[0] = str(ROOT)
    sys.exit(main())
