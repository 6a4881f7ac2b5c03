"""setup_s (host clock): seconds from the process's start to the opening of
the measured window: imports, CUDA initialisation, the kernel library
(built on a checkout's first run, then loaded), the guidance weights, the
clip rendered on the device and copied to the host, and the warm-up
batches."""


def read(run):
    return run.setup_s
