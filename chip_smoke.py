"""Build the PyTorch + CUDA port on one NVIDIA GPU and run every card gate.

Run from the root of a checkout: ``python3 chip_smoke.py``. It

1. prints the environment (torch, CUDA, nvcc, the card's name and power
   limit, TF32 flags, the PNG writers available);
2. builds the port's CUDA kernels from ``video3d_tpu_torch/csrc`` (nvcc,
   sm_90a) and prints the build time;
3. runs the ``cuda``-marked tests of ``tests/test_torch_card.py`` (every
   kernel against its plain twin at the case lists of
   ``video3d_tpu_torch/tools/card_checks.py``) and
   ``tests/test_torch_card_paths.py`` (each path through the entry points a
   user calls), without ``tests/conftest.py``, which imports jax.

Its last line is ``{"ok": true, "device": {...}}``; a failed or erroring
test makes it exit non-zero without that line. There is no CPU mode.
Kernel times: ``python -m video3d_tpu_torch.tools.time_kernels``; stage
rates: ``python3 benchmark/run.py --workload <cell>``.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
CARD_TESTS = ("tests/test_torch_card.py", "tests/test_torch_card_paths.py")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke.py needs a CUDA device; none is visible")
    t_start = time.perf_counter()

    def phase(name: str) -> None:
        print(f"-- {name} (at {time.perf_counter() - t_start:.1f} s)",
              flush=True)
    sys.path.insert(0, str(ROOT))
    from video3d_tpu_torch.core import _native
    from video3d_tpu_torch.kernels import _build

    # -- 1. environment ----------------------------------------------------
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()[-1]
    print(f"nvcc: {nvcc}")
    print(f"card: {card_line()}")
    print(f"tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn={torch.backends.cudnn.allow_tf32}")
    try:
        import cv2
        cv2_version = cv2.__version__
    except ImportError:
        cv2_version = None
    print(f"cv2: {cv2_version}; native PNG writer: "
          f"{'yes' if _native.lib() is not None else 'no'}")

    # -- 2. build ----------------------------------------------------------
    phase("2. build")
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.lib()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"(nvcc {_build.build_seconds or 0.0:.1f} s) "
          f"-> {lib_path.relative_to(ROOT)}")

    # -- 3. the card tests -------------------------------------------------
    phase("3. the card tests")
    rc = subprocess.run(
        [sys.executable, "-m", "pytest", "--noconftest", "-m", "cuda", "-q",
         "-p", "no:cacheprovider", *CARD_TESTS],
        cwd=ROOT).returncode
    phase(f"done, pytest exit code {rc}")
    if rc != 0:
        return 1
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
