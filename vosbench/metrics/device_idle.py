"""The share of the traced part's wall time in which no kernel ran."""


def read(s):
    if not s.get("window_s") or not s.get("busy_s"):
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
