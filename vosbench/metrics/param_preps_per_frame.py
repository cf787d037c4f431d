"""Parameter tensors prepared per frame (the program counter
``models.param_preps``): each kernel or bias cast to the compute dtype on a
call, each batch norm folded on a call."""

from vosbench.metrics._spans import per_unit


def read(s):
    return per_unit(s, "models.param_preps")
