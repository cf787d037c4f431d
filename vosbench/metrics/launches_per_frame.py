"""Kernel launches per frame in the traced part of the window (per push on
a stream): the host's dispatch work that the ``engine`` layer issues."""


def read(s):
    if not s.get("units") or not s.get("launches"):
        return None
    return s["launches"] / s["units"]
