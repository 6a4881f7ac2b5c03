"""The guide's weights: a file of the checkout, or written from a seed.

A configuration's ``weights`` is a path relative to the checkout (the file
the program loads, as shipped), or ``{"seed": n}``: then the guide's kind
(``benchmark/guides/<kind>.py``) writes weights drawn from a
``torch.Generator`` seeded with ``n``, in the layout the program's loader
reads, under the harness's work directory in ``TMPDIR``. The program and
the reference read the same file, so one seed gives both one set of
weights. The directory's name is fixed by the kind, the seed, the device
type and the guide's widths, so a later run in the same ``TMPDIR`` finds
the weights written and writes nothing.
"""

from __future__ import annotations

import hashlib
import json
import math
import shutil
import tempfile
from pathlib import Path

import torch

WORK_DIR = "video3d_bench_work"
DONE = "loads"  # written last: the path the program loads, relative


def work_dir() -> Path:
    """The harness's work directory (the extractor's too), under TMPDIR."""
    return Path(tempfile.gettempdir()) / WORK_DIR


def path(kind, config: dict, root, device) -> Path:
    """The path the program loads the configuration's guide from; seeded
    weights are written by ``kind.weights`` on first use."""
    w = config["weights"]
    if isinstance(w, str):
        return Path(root) / w
    if not (isinstance(w, dict) and set(w) == {"seed"}):
        raise ValueError(f"weights must be a path or {{'seed': n}}: {w!r}")
    guide, seed = config["guide"], int(w["seed"])
    device = torch.device(device)
    key = hashlib.sha256(json.dumps(guide, sort_keys=True).encode())
    out = (work_dir() / "weights"
           / f"{guide['kind']}-{seed}-{device.type}-{key.hexdigest()[:12]}")
    done = out / DONE
    if not done.is_file():
        shutil.rmtree(out, ignore_errors=True)  # a run cut while writing
        out.mkdir(parents=True)
        loads = Path(kind.weights(guide, seed, out, device))
        done.write_text(loads.relative_to(out).as_posix())
    return out / done.read_text()


def seeded(specs: dict, seed: int, device,
           dtype: torch.dtype = torch.float32) -> dict:
    """``{name: (shape, std)}`` -> ``{name: tensor}`` in ``dtype``: one
    normal draw from a ``torch.Generator`` on ``device`` seeded with
    ``seed``, cut in the dict's order and each part scaled by its ``std``
    (0 gives zeros)."""
    device = torch.device(device)
    sizes = [math.prod(shape) for shape, _ in specs.values()]
    gen = torch.Generator(device=device).manual_seed(int(seed))
    flat = torch.randn(sum(sizes), generator=gen, device=device)
    return {name: (part * std).view(shape).to(dtype)
            for (name, (shape, std)), part in zip(specs.items(),
                                                  flat.split(sizes))}
