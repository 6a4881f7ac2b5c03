"""Plain PyTorch ops of the port (counterparts of video3d_tpu.ops)."""
