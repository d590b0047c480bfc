"""device_idle_pct (%, device trace): one minus the union of the device's
kernel, copy and set intervals over the traced window's wall time."""


def read(r):
    if r.trace is None or not r.trace.device_ops or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
