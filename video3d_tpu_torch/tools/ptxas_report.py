"""Registers, spills and shared memory of the port's CUDA kernels.

Compiles each ``video3d_tpu_torch/csrc/*.cu`` with the flags of
``kernels/_build.py`` plus ``-Xptxas -v`` (all sources at once, one nvcc
each) and prints, per kernel whose demangled name contains one of the
given words, what ``ptxas`` reports: registers, spill stores and loads,
static shared memory, barriers; then each source's compile time. Needs
``nvcc`` and ``c++filt``; runs nothing on the card.

Usage: ``python -m video3d_tpu_torch.tools.ptxas_report [word ...]``
(no word: every kernel).
"""

from __future__ import annotations

import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

from video3d_tpu_torch.kernels import _build


def report(words: list) -> int:
    nvcc = _build._nvcc()
    sources = [p for p in _build._sources() if p.suffix == ".cu"]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        procs = [(src, subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-Xptxas", "-v", "-c", str(src), "-o",
             str(Path(tmp) / (src.stem + ".o"))],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
            for src in sources]
        for src, proc in procs:
            _, err = proc.communicate()
            took = time.perf_counter() - t0
            if proc.returncode != 0:
                print(err[-4000:])
                return proc.returncode
            lines = err.splitlines()
            entries = []
            for i, line in enumerate(lines):
                m = re.search(r"Compiling entry function '(\S+)'", line)
                if m:
                    info = " ".join(re.sub(r"ptxas info\s*:", "", x).strip()
                                    for x in lines[i + 1:i + 4]
                                    if "registers" in x or "spill" in x)
                    entries.append((m.group(1), info))
            names = subprocess.run(
                ["c++filt"], input="\n".join(e[0] for e in entries),
                capture_output=True, text=True).stdout.splitlines()
            for name, (_, info) in zip(names, entries):
                if not words or any(w in name for w in words):
                    print(f"{src.name}: {name[:120]} | {info}")
            print(f"{src.name}: compiled {took:.1f} s after the start "
                  f"({len(entries)} kernels)")
    return 0


if __name__ == "__main__":
    sys.exit(report(sys.argv[1:]))
