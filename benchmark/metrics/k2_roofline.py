"""K2's share (%) of its roofline: 8 bytes a sample plus the tables over the
HBM bandwidth, for every oscillator call in the traced slice, over the
device time of the kernels launched under the CPU op `mbexwn::oscillate`."""
from _common import k2_bound, op_roofline


def read(run):
    return op_roofline(run, "mbexwn::oscillate", k2_bound)
