"""Device milliseconds per frame in kernels launched under
``aten::convolution`` (the conv towers: encoders, fusion, decoder)."""


def read(s):
    if not s.get("units") or not s.get("conv_s"):
        return None
    return s["conv_s"] * 1e3 / s["units"]
