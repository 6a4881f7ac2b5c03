"""Temporal smoothers over a batched depth stream.

Counterpart of :mod:`video3d_tpu.parallel.temporal` on one device: the
median-of-3 along the frame axis and its streaming driver, and the
streaming driver of the flow-guided EMA (:mod:`video3d_tpu_torch.ops.
flow`). The frame-sharded variants (``flow_ema_sharded``,
``temporal_median3``) come with multi-GPU scale-out.
"""

from __future__ import annotations

import numpy as np
import torch

from video3d_tpu_torch.ops.flow import FlowEMAParams, flow_ema_scan


def _median3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    return torch.maximum(torch.minimum(torch.maximum(a, b), c),
                         torch.minimum(a, b))


def _median_window(window: torch.Tensor) -> torch.Tensor:
    """(n + 2, H, W) -> (n, H, W) median of each frame and its two
    neighbours. uint16 goes through int32 (torch has no uint16 min/max);
    the median of three values is one of them, so the cast back is
    exact."""
    x = window.to(torch.int32) if window.dtype == torch.uint16 else window
    return _median3(x[:-2], x[1:-1], x[2:]).to(window.dtype)


def temporal_median3_local(depth: torch.Tensor) -> torch.Tensor:
    """Median-of-3 along the leading frame axis, edges clamped."""
    return _median_window(torch.cat([depth[:1], depth, depth[-1:]], dim=0))


class TemporalMedianStream:
    """Streaming median-of-3 over a batched frame stream.

    Frame i's output needs frames i-1 and i+1, so emission lags one
    batch: ``push(batch)`` returns the previous batch filtered (None for
    the first), and ``flush()`` returns the last one. The stream's edges
    clamp, so the outputs equal :func:`temporal_median3_local` on the
    whole stream.
    """

    def __init__(self):
        self._prev = None  # (B, H, W) tensor
        self._prev_prev_last = None  # (1, H, W): the frame before prev[0]

    def _filter_prev(self, right: torch.Tensor) -> torch.Tensor:
        left = (self._prev_prev_last if self._prev_prev_last is not None
                else self._prev[:1])
        return _median_window(torch.cat([left, self._prev, right], dim=0))

    def push(self, batch):
        batch = torch.as_tensor(batch)
        out = None
        if self._prev is not None:
            out = self._filter_prev(batch[:1])
            self._prev_prev_last = self._prev[-1:]
        self._prev = batch
        return out

    def flush(self):
        if self._prev is None:
            return None
        out = self._filter_prev(self._prev[-1:])
        self._prev = None
        self._prev_prev_last = None
        return out


class TemporalFlowEMAStream:
    """Streaming flow-guided EMA over a batched frame stream.

    Causal, so there is no emission lag: ``push(depth, guide)`` returns
    the same batch filtered, as uint16 ``clip(round(x), 0, 65535)``
    (round half to even, as ``jnp.round``). The carry (previous smoothed
    frame and guide, f32) stays on the device between batches. Frame 0 of
    the stream passes through bit for bit and seeds the carry, unless an
    initial ``carry`` -- numpy (H, W) smoothed depth and (hq, wq) guide,
    e.g. taken from the JAX stream -- continues an earlier stream.
    """

    def __init__(self, params: FlowEMAParams = None, carry=None):
        self.params = params or FlowEMAParams()
        self._carry = None
        if carry is not None:
            self._carry = tuple(
                torch.tensor(np.asarray(c, dtype=np.float32))
                for c in carry)

    def push(self, depth, guide) -> torch.Tensor:
        """(B, H, W) uint16 depth + (B, hq, wq) guide -> (B, H, W) uint16."""
        depth = torch.as_tensor(depth)
        guide = torch.as_tensor(guide)
        head = None
        if self._carry is None:
            head = depth[:1]  # frame 0: bit-exact passthrough
            self._carry = (depth[0].to(torch.float32),
                           guide[0].to(torch.float32))
            depth, guide = depth[1:], guide[1:]
        else:
            self._carry = tuple(c.to(depth.device) for c in self._carry)
        if depth.shape[0] == 0:
            out = depth.to(torch.uint16)
        else:
            self._carry, out = flow_ema_scan(self._carry, depth, guide,
                                             self.params)
            out = torch.clamp(torch.round(out), 0.0, 65535.0)
            out = out.to(torch.int32).to(torch.uint16)
        return out if head is None else torch.cat([head, out], dim=0)

    def flush(self):
        self._carry = None
        return None
