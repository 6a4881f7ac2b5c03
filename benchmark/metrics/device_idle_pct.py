"""device_idle_pct (device trace): the share of the traced sub-window in
which no kernel, copy or set ran on the device: 1 - busy / window."""


def read(run):
    t = run.trace
    if not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
