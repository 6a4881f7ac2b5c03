"""frames_per_s (host clock): depth maps whose readback completed inside
the window, over the window's length."""


def read(run):
    return run.frames / run.seconds
