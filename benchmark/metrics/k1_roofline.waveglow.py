"""K1's share (%) of its roofline in the WaveGlow cell: the least time of
every WaveNet stack call in the traced slice (counts_waveglow.
k1_work_per_layer_cond at the call's C and layers, from its shapes: x
(B, T, C), cond (B, T, L, 2C), w_dil (L, 2C, 3, Cp); against the bf16 peak
and HBM bandwidth) over the device time of the kernels launched under the
CPU op `mbexwn::wavenet_stack`."""
import counts
import counts_waveglow
from _common import op_roofline


def bound(shapes):
    (B, T, _), cond, w_dil = shapes[0], shapes[1], shapes[2]
    return counts.roofline_seconds(*counts_waveglow.k1_work_per_layer_cond(B, T, cond[-1] // 2, w_dil[0]))


def read(run):
    return op_roofline(run, "mbexwn::wavenet_stack", bound)
