"""The program's spans as per-batch values, for the per-layer metrics that
read them.

The port records spans at its layer boundaries while ``torch.profiler``
records (``video3d_tpu_torch/core/trace.py``): in a run, the traced
sub-window's batches. :func:`per_batch` sums one field of some span names
over the sub-window and divides by its ``stage`` spans, one a batch. It
returns None where the program has no span recorder (a tree before it),
recorded no batch, or has no device time for the names.
"""

from __future__ import annotations


def summary():
    """The program's span summary ({name: {count, host_ms, device_ms,
    device_count, counts}}), or None without a recorder or a batch."""
    try:
        from video3d_tpu_torch.core import trace
    except ImportError:
        return None
    table = trace.summary()
    if not table.get("stage", {}).get("count"):
        return None
    return table


def per_batch(names, field: str):
    """``field`` ("host_ms" or "device_ms") of the spans ``names``, summed,
    per ``stage`` span; None where none of them has it."""
    table = summary()
    if table is None:
        return None
    rows = [table[n] for n in names if n in table]
    if field == "device_ms":
        rows = [r for r in rows if r["device_count"]]
    if not rows:
        return None
    return sum(r[field] for r in rows) / table["stage"]["count"]
