"""Build and load the port's CUDA kernels.

At first use, ``nvcc`` compiles every ``video3d_tpu_torch/csrc/*.cu`` for
``sm_90a``, one process per source, all started together, and links the
objects into one shared library with a plain C interface, which is
loaded with ``ctypes``. The library lands in ``build/kernels/`` at the
root of the checkout (listed in ``.gitignore``), named by a hash of the
sources and flags, so an edited source rebuilds and an unchanged one is
reused. No ``--use_fast_math``, and ``-fmad=false``: the kernels' f32
steps (prefilter rounding, sub-pixel division, speckle bands) must round
like the plain PyTorch twins.

Every C entry takes tensor pointers and the CUDA stream as ``void*`` and
returns ``cudaGetLastError()`` after its launches; :func:`check` raises on
a non-zero code.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
_SRC_DIR = _PKG / "csrc"
_BUILD_DIR = _PKG.parent / "build" / "kernels"

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-Xcompiler", "-fPIC",
]

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# C entry points and their argument types (pointers and stream as void*)
_SIGNATURES = {
    # costvol.cu
    "v3d_prefilter": [_P, _P, _P, _P, _I, _I, _I, _F, _P],
    "v3d_cost_volume": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # sgm.cu
    "v3d_sgm_horizontal": [_P, _P, _I, _I, _I, _I, _F, _F, _I, _I, _P, _P],
    "v3d_sgm_vertical": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _F, _F, _I, _I, _I, _I, _I, _I, _P, _P],
    "v3d_sgm_vertical_scratch": [_I, _I, _I],
    "v3d_sgm_vertical_keys": [_I, _I, _I, _I, _I],
    "v3d_sgm_lr_check": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # wmajor.cu
    "v3d_wmajor_sweep": [_P, _P, _P, _I, _I, _I, _I, _F, _F, _I, _I, _I,
                         _P, _P],
    "v3d_wmajor_horizontal": [_P, _P, _I, _I, _I, _I, _F, _F, _I, _I, _P,
                              _P],
    "v3d_wmajor_transpose": [_P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    # probe_i16.cu
    "v3d_probe_i16_all": [_P, _P, _P, _P, _I, _I, _I, _P],
    # speckle.cu
    "v3d_speckle": [_P, _P, _I, _I, _I, _F, _F, _F, _I, _I, _I, _P],
    # warp.cu
    "v3d_warp": [_P, _P, _P, _P, _I, _I, _I, _P],
    "v3d_ema_guide": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _P],
    "v3d_ema_step": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P,
                     _F, _F, _I, _I, _I, _F, _F, _P, _P],
    "v3d_ema_blocks": [_I, _I],
    # flowmatch.cu
    "v3d_flow_level": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P,
                       _F, _F, _I, _I, _I, _I, _F, _P],
    # image.cu
    "v3d_eyes_gray": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # attention.cu
    "v3d_attention": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    # blend.cu
    "v3d_fill_holes": [_P, _P, _I, _I, _I, _F, _P],
    "v3d_blend_scratch": [_I, _I],
    "v3d_trust_blend": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _F,
                        _P],
    # agcl.cu
    "v3d_agcl": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
}

_lib = None
build_seconds = None  # wall time of the build this process ran, if any


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list:
    return sorted(_SRC_DIR.glob("*.cu")) + sorted(_SRC_DIR.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in _sources():
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return _BUILD_DIR / f"libv3dkernels-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the kernels if the library for these sources is missing."""
    global build_seconds
    out = library_path()
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs, procs = [], []
    for src in (p for p in _sources() if p.suffix == ".cu"):
        obj = out.with_name(f"{out.stem}.{src.stem}.{os.getpid()}.o")
        objs.append(obj)
        procs.append(subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    try:
        failed = []
        for proc in procs:
            stdout, stderr = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{' '.join(proc.args)} ({proc.returncode}):"
                              f"\n{stdout}\n{stderr}")
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        res = subprocess.run([nvcc, "-shared", "-o", str(tmp),
                              *map(str, objs)],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc link failed ({res.returncode}):\n{res.stdout}\n"
                f"{res.stderr}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    if _lib is None:
        handle = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(handle, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = handle
    return _lib


def check(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device: the
    value of ``torch.cuda.current_stream(t.device).cuda_stream``, read
    without building a Stream object at every launch."""
    import torch

    return torch._C._cuda_getCurrentRawStream(t.device.index)


def require(t, dtype, ndim: int, name: str) -> None:
    """Check what a kernel takes: a contiguous CUDA tensor of ``dtype``."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {t.dim()}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
