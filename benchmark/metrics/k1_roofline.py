"""K1's share (%) of its roofline: the least time of every WaveNet stack call
in the traced slice (counts.k1_work at the published C, from each call's
shapes, against the bf16 peak and HBM bandwidth) over the device time of
the kernels launched under the CPU op `mbexwn::wavenet_stack`."""
from _common import k1_bound, op_roofline


def read(run):
    return op_roofline(run, "mbexwn::wavenet_stack", k1_bound)
