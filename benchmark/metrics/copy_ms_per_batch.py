"""copy_ms_per_batch (device trace): device time of the host-to-device and
device-to-host copies in the traced sub-window, per batch: the batch's
upload and its maps' readback."""


def read(run):
    t = run.trace
    if not t.get("batches") or not t.get("window_s"):
        return None
    return (t["h2d_s"] + t["d2h_s"]) * 1e3 / t["batches"]
