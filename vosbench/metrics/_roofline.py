"""A custom op's share of its roofline: the least time of the work of all
its traced calls (``vosbench.flops.roofline_s``) over the device time of
the kernels launched under the op."""

from vosbench.flops import roofline_s


def share(s, op):
    t, n = s.get("op_s", {}).get(op), s.get("op_calls", {}).get(op)
    work = s.get("op_work", {}).get(op)
    if not t or not n or work is None:
        return None
    return 100.0 * n * roofline_s(*work) / t
