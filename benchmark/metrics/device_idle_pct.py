"""device_idle_pct: the percent of the traced window in which no
operation ran on the card (1 - the union of device intervals over the
window)."""


def read(run):
    t = run.trace
    if not t or not t.get("window_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
