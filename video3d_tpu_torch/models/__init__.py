"""Guidance models of the port (counterparts of video3d_tpu.models)."""
