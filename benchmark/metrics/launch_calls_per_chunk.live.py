"""Host-side launch calls (cudaLaunchKernel, cuLaunchKernel(Ex),
cudaLaunchCooperativeKernel, cudaGraphLaunch) in the traced slice per live
chunk completed in it."""
from _common import per_unit


def read(run):
    return per_unit(run, "chunks")
