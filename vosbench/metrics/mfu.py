"""The whole step's share of the chip's peak: the model's operations
(``vosbench.flops``) of the work done outside the traced part, over its
wall time, against the peak of the configuration's tower dtype."""

from vosbench.flops import peak_flops


def read(s):
    if not s.get("mfu_seconds") or not s.get("mfu_flops"):
        return None
    return 100.0 * s["mfu_flops"] / s["mfu_seconds"] / peak_flops(s["dtype"])
