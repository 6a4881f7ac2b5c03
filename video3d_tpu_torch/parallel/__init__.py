"""Temporal smoothing over the frame stream (single device)."""
