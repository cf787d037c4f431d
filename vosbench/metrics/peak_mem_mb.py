"""Peak device memory allocated in the window (the caching allocator's
count, reset at the window's start), in MB of 10^6 bytes."""


def read(s):
    if not s.get("peak_bytes"):
        return None
    return s["peak_bytes"] / 1e6
