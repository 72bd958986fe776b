import numpy as np


def nextpow2(n):
    """Smallest integer e with 2**e >= n."""
    return int(np.ceil(np.log2(n)))


def nextpow2_val(n):
    """Smallest power of two >= n (at least 2)."""
    v = 2
    while v < n:
        v *= 2
    return v
