"""Pipeline stages of the port (counterparts of video3d_tpu.stages)."""
