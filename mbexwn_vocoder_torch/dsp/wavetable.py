"""Band-limited LF glottal-pulse wavetable construction (init-time NumPy).

Builds the log-spaced F0 grid of band-limited LF pulses used by the wavetable
oscillator.  Behavioural parity target:
reference: MBExWN_NVoc/vocoder/model/tf_wavetable.py:37-162 (pulse design) and
tf_wavetable.py:216-307 (grid construction).  Runtime lookup is in
ops/oscillator.py.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import scipy.signal as ss

from .glottis import lf_pulse_spectrum
from .resample import kaiser_fir_length


def pulse_lowpass_kaiser(pass_band_edge, stop_att_db=70, trans_width_normed=0.1):
    """Kaiser FIR low-pass whose first spectral zero sits at pass_band_edge.

    Frequencies are normalized to the sample rate (Nyquist = 0.5); the sizing
    rule (incl. the tap-budget back-off) is shared with dsp/resample.py.
    Behavioural parity target: tf_wavetable.py:37-80.
    """
    half_len, beta, _ = kaiser_fir_length(stop_att_db, 2 * np.pi * trans_width_normed)
    return ss.firwin(
        half_len * 2 + 1,
        cutoff=[pass_band_edge - 0.5 * trans_width_normed],
        window=("kaiser", beta),
        pass_zero=True,
        fs=1.0,
    )


def min_phase_spectrum(log_magnitude: np.ndarray) -> np.ndarray:
    """Minimum-phase spectrum from a log-magnitude half-spectrum via the
    real-cepstrum folding trick.  reference: tf_wavetable.py:82-89"""
    fft_size = log_magnitude.shape[-1] * 2 - 2
    real_cepst = np.fft.irfft(np.fmax(log_magnitude, np.finfo(log_magnitude.dtype).eps), n=fft_size)
    mask = np.concatenate(([1.0], 2 * np.ones(fft_size // 2 - 1), [1.0]), axis=0)
    log_spect = np.fft.rfft(real_cepst[: mask.shape[0]] * mask, n=fft_size)
    return np.exp(log_spect)


def lf_pulse(
    n_wavetable: int,
    oq: float = 0.5,
    am: float = 0.7,
    rta: float = 0.1,
    pul_bw: float = 0.1,
    use_deriv: bool = False,
    transition_width: float = 0.1,
    quiet: bool = False,
    norm: bool = False,
    white_pulse: bool = False,
) -> np.ndarray:
    """One band-limited LF pulse period, length = nextpow2(n_wavetable).

    The pulse is designed directly in the spectral domain (coherently band
    limited): closed-form LF spectrum x kaiser low-pass magnitude, then irfft.
    reference: tf_wavetable.py:93-162
    """
    T0 = n_wavetable
    fft_size = 16
    while fft_size < n_wavetable:
        fft_size *= 2

    fft_freq_hz = np.arange(fft_size // 2 + 1) / fft_size  # sample-rate-normalized

    syn_pulse_spec = lf_pulse_spectrum(
        fft_freq_hz * T0, oq=oq, am=am, ta=rta * (1 - oq), get_derivative=use_deriv, orig=0
    )[0]

    if white_pulse:
        # flatten the spectral envelope above the pulse's peak via a
        # minimum-phase whitening filter (tf_wavetable.py:110-120)
        n_max_pulse_pos = np.argmax(syn_pulse_spec)
        n_max_white_pos = np.fmax(n_max_pulse_pos, int(fft_size * (pul_bw - 0.5 * transition_width)))
        wfilt = np.ones(syn_pulse_spec.shape)
        if n_max_pulse_pos < n_max_white_pos:
            wfilt[n_max_pulse_pos:n_max_white_pos] = np.abs(syn_pulse_spec[n_max_pulse_pos]) / np.abs(
                syn_pulse_spec[n_max_pulse_pos:n_max_white_pos]
            )
            wfilt[n_max_white_pos:] = np.abs(syn_pulse_spec[n_max_pulse_pos]) / np.abs(
                syn_pulse_spec[n_max_white_pos]
            )
            syn_pulse_spec = syn_pulse_spec * min_phase_spectrum(np.log(wfilt))

    fcoef = pulse_lowpass_kaiser(
        pul_bw, stop_att_db=70, trans_width_normed=np.fmin(pul_bw / 2.0, transition_width)
    )
    # frequency-domain subsampling of the filter transfer function; the
    # resulting temporal aliasing is harmless for quasi-periodic use
    filter_fftsize_factor = 1
    while fcoef.shape[0] > fft_size * filter_fftsize_factor:
        filter_fftsize_factor *= 2
    filter_fft = np.fft.rfft(fcoef, fft_size * filter_fftsize_factor)[::filter_fftsize_factor]
    filter_fft[-1] = np.real(filter_fft[-1])
    syn_pulse_spec = syn_pulse_spec * np.abs(filter_fft)

    pp = np.fft.irfft(syn_pulse_spec, fft_size)

    if norm:
        if use_deriv:
            pp = -pp / np.min(pp)
        else:
            pp = pp / np.max(pp)
    return pp


def create_normed_pulse(
    Oq: float,
    target_nominalF0: float,
    nominalBandWidth: float,
    sample_rate,
    am: float = 0.8,
    rta: float = 0.1,
    use_radiation: bool = False,
    bandWidthReductionFactor: float = 1.0,
    wt_oversampling: int = 1,
    return_nominal_f0: bool = False,
    quiet: bool = False,
    use_sinusoid: bool = False,
    use_white_pulse: bool = False,
):
    """One wavetable entry (a single band-limited period).

    reference: tf_wavetable.py:309-410 (see that docstring for the wavetable
    size / band-limit theory).
    """
    if use_sinusoid:
        period = int(wt_oversampling * np.floor(sample_rate / target_nominalF0))
        n = np.arange(period)
        # windowed sinusoid (hann, periodic)
        res = np.sin(n / period * np.pi * 2) * (0.5 - 0.5 * np.cos(2 * np.pi * n / period))
        nominalF0 = wt_oversampling * sample_rate / period
    else:
        res = lf_pulse(
            int(np.ceil(wt_oversampling * sample_rate / target_nominalF0)),
            oq=Oq,
            am=am,
            rta=rta,
            pul_bw=nominalBandWidth / (bandWidthReductionFactor * wt_oversampling),
            transition_width=0.1 / wt_oversampling,
            use_deriv=use_radiation,
            quiet=quiet,
            white_pulse=use_white_pulse,
        )
        nominalF0 = wt_oversampling * sample_rate / res.shape[0]

    if return_nominal_f0:
        return res, nominalF0
    return res


@dataclass
class WavetableSpec:
    """Static wavetable data produced at init time.

    wavetables: (n_wavetable, n_grid) float32; each column is one band-limited
    pulse with its first sample appended at the end for wrap-around lerp.
    """

    wavetables: np.ndarray
    F0_list: List[float]
    nominalF0: float
    sample_rate: float
    F0GridFactor: float
    add_subharm_chans: int = 0
    use_sinusoid: bool = False
    use_sinusoid_as_fun: bool = False

    @property
    def n_wavetable(self) -> int:
        return self.wavetables.shape[0]

    @property
    def n_period(self) -> int:
        return self.wavetables.shape[0] - 1

    @property
    def min_transposition(self) -> float:
        return float(np.min(self.F0_list) / self.nominalF0)

    @property
    def max_transposition(self) -> float:
        return float(np.max(self.F0_list) / self.nominalF0)


def build_wavetable_grid(
    sample_rate,
    nominalF0: float,
    nominalBandWidth: Optional[float] = None,
    Oq: float = 0.5,
    am: float = 0.8,
    rta: float = 0.05,
    use_radiation: bool = False,
    F0GridFactor: float = 1.25,
    numF0InGrid: int = 5,
    maxF0: Optional[float] = None,
    wt_oversampling: int = 2,
    use_sinusoid: bool = False,
    use_sinusoid_as_fun: bool = False,
    use_white_pulse: bool = False,
    add_subharm_chans: int = 0,
    quiet: bool = True,
    # accepted-but-runtime-only options (handled by the oscillator)
    pulse_sync_gain_avg: bool = False,
    no_interp: bool = False,
    trainable=None,
) -> WavetableSpec:
    """Log-spaced F0 grid of band-limited pulses.

    Grid entry i holds the same pulse band-limited by F0GridFactor**i so that
    playing it transposed up by that factor stays alias-free.
    reference: tf_wavetable.py:216-307
    """
    default_bandwidth = 0.5 / F0GridFactor
    if nominalBandWidth is not None and np.abs((nominalBandWidth - default_bandwidth) / default_bandwidth) > 1e-4:
        if not quiet:
            print(f"ATTENTION: overriding default pulse bandwidth {default_bandwidth} with {nominalBandWidth}")
    use_sin = use_sinusoid or use_sinusoid_as_fun

    # probe run with extreme band limitation to fix the realizable nominal F0
    # (the fft-size rounding in lf_pulse changes the period length)
    _, adj_nominalF0 = create_normed_pulse(
        Oq,
        target_nominalF0=nominalF0,
        nominalBandWidth=0.5 / F0GridFactor,
        sample_rate=sample_rate,
        am=am,
        rta=rta,
        use_radiation=use_radiation,
        bandWidthReductionFactor=(maxF0 / nominalF0) if maxF0 else 1.0,
        wt_oversampling=wt_oversampling,
        return_nominal_f0=True,
        quiet=quiet,
        use_sinusoid=use_sin,
        use_white_pulse=use_white_pulse,
    )
    nominalF0 = adj_nominalF0

    if not use_sin:
        used_numF0InGrid = numF0InGrid
        if maxF0 is not None:
            used_numF0InGrid = int(np.ceil(np.log(maxF0 / nominalF0) / np.log(F0GridFactor)))
    else:
        used_numF0InGrid = 0

    F0_list = []
    wavetable_list = []
    for ir in range(used_numF0InGrid + 1):
        rs = F0GridFactor**ir if ir > 0 else 1
        wavetable = create_normed_pulse(
            Oq,
            target_nominalF0=nominalF0,
            nominalBandWidth=0.5,
            sample_rate=sample_rate,
            am=am,
            rta=rta,
            use_radiation=use_radiation,
            bandWidthReductionFactor=rs,
            wt_oversampling=wt_oversampling,
            use_sinusoid=use_sin,
            quiet=quiet,
            use_white_pulse=use_white_pulse,
        ).astype(np.float32)
        F0_list.append(nominalF0 * rs)
        # append the first sample for smooth wrap-around linear interpolation
        wavetable_list.append(np.concatenate([wavetable, wavetable[0:1]], axis=0)[:, np.newaxis])

    norm_factor = -np.min([wavetable_list])
    wavetables = np.concatenate([wl / norm_factor for wl in wavetable_list], axis=1).astype(np.float32)

    return WavetableSpec(
        wavetables=wavetables,
        F0_list=F0_list,
        nominalF0=float(nominalF0),
        sample_rate=float(sample_rate),
        F0GridFactor=float(F0GridFactor),
        add_subharm_chans=add_subharm_chans,
        use_sinusoid=use_sinusoid,
        use_sinusoid_as_fun=use_sinusoid_as_fun,
    )
