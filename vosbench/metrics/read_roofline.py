"""K2, the fused memory read (the op ``swem_tpu_torch::read_normalized``):
share of its roofline."""

from vosbench.metrics._roofline import share


def read(s):
    return share(s, "swem_tpu_torch::read_normalized")
