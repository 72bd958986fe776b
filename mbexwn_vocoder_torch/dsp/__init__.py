"""Init-time NumPy signal design (wavetables, PQMF banks, windows, mel
scale), copied from the JAX package so the port imports nothing of it."""
