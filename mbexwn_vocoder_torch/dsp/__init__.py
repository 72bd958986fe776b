"""Host-side NumPy signal code copied from the JAX package so the port
imports nothing of it: init-time design (wavetables, PQMF banks, windows,
mel scale) and the mel analysis front end (STFT, resampling, YIN F0)."""
