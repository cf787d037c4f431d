"""K1, the EM loop (the op ``swem_tpu_torch::em_loop``): share of its
roofline."""

from vosbench.metrics._roofline import share


def read(s):
    return share(s, "swem_tpu_torch::em_loop")
