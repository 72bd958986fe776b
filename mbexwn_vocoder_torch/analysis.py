"""Mel-spectrogram analysis front end (host-side NumPy): log/linear mel
scaling, offline mel/sound RMS normalisation, the log-mel analysis of audio
(STFT magnitude through the Slaney mel filterbank) and the extended-range
mel interpolator.  Copy of the JAX package's analysis.py, which is NumPy
there too; the quality numbers depend on its framing, mel basis and
resampler, so it is copied, not re-derived.
"""
from __future__ import annotations

import numpy as np
import scipy.interpolate

from .dsp.mel import mel_filter, mel_frequencies
from .dsp.stft import calc_stft
from .dsp.windows import get_stft_window


def scale_mel_spectrogram(mel_spectrogram, preprocess_config, forward=True):
    """Linear <-> log mel scaling with lin/mel amp scale/offset conventions."""
    lin_amp_scale = preprocess_config.get("lin_amp_scale", 1)
    lin_amp_off = preprocess_config.get("lin_amp_off", 1.0e-5)
    if lin_amp_off is None:
        lin_amp_off = 1.0e-5
    mel_amp_scale = preprocess_config.get("mel_amp_scale", 1)
    use_max_limit = preprocess_config.get("use_max_limit", False)

    if forward:
        mel = np.array(mel_spectrogram) * lin_amp_scale
        if use_max_limit:
            return mel_amp_scale * np.log(np.fmax(mel, lin_amp_off)).astype(np.float32)
        return mel_amp_scale * np.log(mel + lin_amp_off).astype(np.float32)

    mel = np.exp(mel_spectrogram / mel_amp_scale).astype(np.float32)
    if not use_max_limit:
        mel = mel - lin_amp_off
    return mel / lin_amp_scale


def norm_mell(mell, preprocess_config, snd=None, de_normalize_snd=False, mell_is_log=True,
              norm_max=None, norm_max_fac=None, num_smooth_iters=None, smooth_win_scale=1.0,
              return_snd_gain=False, normalize_compressor_exp=None, use_pinv=False,
              old_gain_smooth=False):
    """Offline mel/sound RMS normalisation with overlap-add gain smoothing.

    reference: preprocess.py:129-378 (numpy path).
    """
    hop_size = preprocess_config["hop_size"]
    win_size = preprocess_config["win_size"]
    if 4 * hop_size != win_size:
        raise RuntimeError("norm_mell:error: only win_size == 4*hop_size is supported")
    fft_size = preprocess_config["fft_size"]

    if norm_max is None:
        norm_max = preprocess_config.get("norm_mel", {}).get("norm_max_fac", False) if isinstance(
            preprocess_config.get("norm_mel"), dict) else False
    if num_smooth_iters is None:
        nm = preprocess_config.get("norm_mel")
        num_smooth_iters = nm["num_smooth_iters"] if isinstance(nm, dict) and "num_smooth_iters" in nm else 1

    mell = np.asarray(mell)
    mell_test = np.exp(mell) if mell_is_log else np.array(mell)

    if not norm_max:
        if use_pinv:
            wnorm_sq = np.sum(get_stft_window("hann", win_size, np.float32) ** 2)
            mel_basis = mel_filter(
                sr=preprocess_config["sample_rate"], n_fft=fft_size,
                n_mels=preprocess_config["mel_channels"],
                fmin=preprocess_config["fmin"], fmax=preprocess_config["fmax"],
            )
            mbi = np.linalg.pinv(mel_basis)
            mell_test = np.dot(mell_test, mbi.T) / np.sqrt(wnorm_sq)
            wnorm = 1
        else:
            n_mels = preprocess_config["mel_channels"]
            mel_f = mel_frequencies(n_mels=n_mels + 2, fmin=preprocess_config["fmin"],
                                    fmax=preprocess_config["fmax"])
            inv_enorm = ((mel_f[2 : n_mels + 2] - mel_f[:n_mels]) / 2.0).astype(np.float32)
            mell_test = mell_test * inv_enorm
            wnorm = win_size

    ana_win = get_stft_window("hann", win_size, np.dtype("float32"))[np.newaxis, :]
    gain_ana_win = ana_win / np.sum(ana_win)
    smooth_win_size = int(win_size * smooth_win_scale)
    smooth_syn_win = get_stft_window("hann", smooth_win_size, np.dtype("float32"))[np.newaxis, :]
    if old_gain_smooth:
        # legacy mode: square the window (reference preprocess.py:248-252)
        smooth_syn_win = smooth_syn_win**2
    n_frames = mell.shape[1]
    gain_off = 0
    gain = None

    if num_smooth_iters:
        for it in range(num_smooth_iters):
            if norm_max:
                norm_fact_hop_grid = np.fmax(np.finfo(mell.dtype).eps, np.max(mell_test, axis=-1))
            else:
                if it == 0:
                    norm_fact_hop_grid = np.sqrt(
                        2 * np.sum(mell_test**2, axis=-1) / fft_size / wnorm
                    ).astype(np.float32)
                else:
                    norm_fact_hop_grid = mell_test[..., 0]
            if norm_max_fac:
                norm_fact_hop_grid = np.fmax(norm_fact_hop_grid, 1 / norm_max_fac)
            if normalize_compressor_exp is not None:
                norm_fact_hop_grid = norm_fact_hop_grid**normalize_compressor_exp

            # overlap-add the per-frame gains through the (squared) synthesis
            # window and normalise by the window OLA sum (preprocess.py:296-323)
            gain = np.zeros((mell.shape[0], ((mell.shape[1] + 4) * hop_size + smooth_win_size)),
                            dtype=mell.dtype)
            norm_gain = np.zeros((1, gain.shape[1]), dtype=mell.dtype)
            start_ind = 0
            for ii in range(-2, norm_fact_hop_grid.shape[-1] + 3):
                ii_cut = int(np.fmin(np.fmax(ii, 0), norm_fact_hop_grid.shape[-1] - 1))
                seg = smooth_syn_win[..., 0 : np.fmin(smooth_win_size, gain.shape[-1] - start_ind)]
                gain[:, start_ind : start_ind + smooth_win_size] += seg * norm_fact_hop_grid[..., ii_cut : ii_cut + 1]
                norm_gain[:, start_ind : start_ind + smooth_win_size] += seg
                start_ind += hop_size

            gain = gain[:, smooth_win_size // 2 + 2 * hop_size - win_size // 2 :]
            norm_gain = norm_gain[:, smooth_win_size // 2 + 2 * hop_size - win_size // 2 :]
            gain = gain / np.fmax(np.finfo(mell.dtype).eps, norm_gain)

            idx = np.arange(n_frames)[:, None] * hop_size + np.arange(win_size)[None, :]
            gain_frames = gain[:, idx]
            realizable_mel_gain = np.sum(gain_frames * gain_ana_win, axis=-1, keepdims=True)[:, : mell.shape[1]]
            mell_test = realizable_mel_gain
            if normalize_compressor_exp is not None:
                mell_test = mell_test ** (1 / normalize_compressor_exp)
            gain_off = int(win_size // 2)
    else:
        realizable_mel_gain = np.sqrt(2 * np.sum(mell_test**2, axis=-1) / fft_size / wnorm)[:, :, np.newaxis]
        gain = scipy.interpolate.interp1d(
            np.arange(realizable_mel_gain.shape[1]) * hop_size, realizable_mel_gain, axis=1,
            fill_value="extrapolate",
        )(np.arange((realizable_mel_gain.shape[1] + 2) * hop_size))[:, :, 0]
        gain_off = 0

    if mell_is_log:
        mel_out = mell - np.log(np.fmax(np.finfo(mell.dtype).eps, realizable_mel_gain))
    else:
        mel_out = mell / np.fmax(np.finfo(mell.dtype).eps, realizable_mel_gain)

    if snd is not None:
        snd_gain = np.fmax(gain[..., gain_off : gain_off + snd.shape[-1]], np.finfo(gain.dtype).eps)
        snd_out = snd * snd_gain if de_normalize_snd else snd / snd_gain
        if return_snd_gain:
            return mel_out, snd_out.reshape(snd.shape), snd_gain
        return mel_out, snd_out.reshape(snd.shape)
    snd_gain = np.fmax(gain[..., gain_off:], np.finfo(gain.dtype).eps)
    if return_snd_gain:
        return mel_out, snd_gain
    return mel_out


def compute_mel_spectrogram_internal(sound, preprocess_config, dtype=np.dtype("float32"),
                                     force=False, band_limit=None, pad_mode="reflect",
                                     center=True, return_STFT=False, do_post=True,
                                     return_band_limited_mel=False):
    """Log-amplitude mel spectrogram (B, T, n_mels) from audio (B, T_samples).

    reference: preprocess.py:417-572.  The STFT-domain band-limit path
    (band_limit=(low_hz, high_hz, stop_hz): zero below low, linear fade
    high->stop, zero above stop; preprocess.py:493-545) needs an external
    unshipped STFT class upstream -- here it runs natively on dsp/stft.py's
    analysis/LSE-resynthesis pair.
    """
    sound = np.asarray(sound)
    if (not force) and (np.max(sound.shape) != sound.shape[-1]):
        raise RuntimeError(
            "sound shape is not maximal in the last dimension, if you are sure the last dimension "
            "is time you can force processing with the force argument"
        )
    if sound.ndim == 1:
        sound = sound[np.newaxis, :]

    win_len = preprocess_config.get("win_size", preprocess_config["fft_size"])
    fft_size = preprocess_config["fft_size"]
    hop_size = preprocess_config["hop_size"]

    if band_limit is None:
        S = calc_stft(sound, win_len=win_len, hop_len=hop_size,
                      fft_size=fft_size, win_type="hann", center=center,
                      pad_mode=pad_mode, do_mag=True, axis=-1, dtype=dtype)
    else:
        if len(band_limit) != 3:
            raise RuntimeError(
                "compute_mel_spectrogram_internal::if the band_limit parameter is not None it needs "
                "to contain three values: band_lim_low_hz, band_lim_high_hz, band_stop_high_hz"
            )
        from .dsp.stft import calc_istft

        spec = calc_stft(sound, win_len=win_len, hop_len=hop_size, fft_size=fft_size,
                         win_type="hann", center=center, pad_mode=pad_mode,
                         do_mag=False, axis=-1, dtype=dtype)
        bin_freqs = np.arange(fft_size // 2 + 1) * preprocess_config["sample_rate"] / fft_size
        filt = np.ones((1, bin_freqs.size), dtype=dtype)

        def _first_larger(v):  # find_1st(..., cmp_larger) semantics incl. -1
            above = bin_freqs > v
            return int(np.argmax(above)) if above.any() else -1

        if band_limit[0]:
            ind = _first_larger(band_limit[0])
            if ind >= 0:
                filt[:, :ind] = 0
        if band_limit[1]:
            ind_high = _first_larger(band_limit[1])
            ind_stop = _first_larger(band_limit[2])
            if ind_high >= 0 and ind_stop > ind_high:
                filt[:, ind_high:ind_stop] = np.linspace(1, 0, ind_stop - ind_high)
            if ind_stop > 0:
                filt[:, ind_stop:] = 0

        if not return_band_limited_mel:
            S = np.abs(spec).astype(dtype)
        spec = spec * filt
        sound = calc_istft(spec, win_len=win_len, hop_len=hop_size, fft_size=fft_size,
                           length=sound.shape[-1], win_type="hann", dtype=dtype)
        if return_band_limited_mel:
            S = np.abs(spec).astype(dtype)

    mel_basis = mel_filter(sr=preprocess_config["sample_rate"], n_fft=preprocess_config["fft_size"],
                           n_mels=preprocess_config["mel_channels"],
                           fmin=preprocess_config["fmin"], fmax=preprocess_config["fmax"], dtype=dtype)
    mel_spectrogram = np.dot(S, mel_basis.T)

    sound_out = sound
    if do_post:
        if preprocess_config.get("norm_mel"):
            mel_spectrogram, sound_out = norm_mell(mel_spectrogram, preprocess_config=preprocess_config,
                                                   snd=sound, mell_is_log=False)
        mell = scale_mel_spectrogram(mel_spectrogram, preprocess_config=preprocess_config)
    else:
        mell = np.log(np.fmax(mel_spectrogram, np.finfo(mel_spectrogram.dtype).eps))

    mel_srate = preprocess_config["sample_rate"] / preprocess_config["hop_size"]

    if do_post and preprocess_config.get("norm_mel"):
        if return_STFT:
            return mell, mel_srate, S, sound_out
        return mell, mel_srate, sound_out
    if return_STFT:
        return mell, mel_srate, S
    return mell, mel_srate


def get_mel_lin_interpol_params(preprocess_config, n_fft):
    """Extended-range unnormalized mel basis for mel-domain interpolation.

    reference: preprocess.py:381-414.  Returns (gain_fac, mel_interpolator,
    ext_low_int, ext_high_int): gain_fac undoes the slaney area norm of the
    model's mel basis; mel_interpolator is an unnormalized triangle basis on
    the same mel grid extended below fmin and above fmax so the full
    [0, sr] range is covered while the original band centers are preserved.
    """
    from .dsp.mel import hz_to_mel, mel_to_hz

    mel_basis = mel_filter(
        sr=preprocess_config["sample_rate"], n_fft=preprocess_config["fft_size"],
        n_mels=preprocess_config["mel_channels"],
        fmin=preprocess_config["fmin"], fmax=preprocess_config["fmax"],
    )
    gain_fac = np.sum(mel_basis, axis=1)

    n_mels = preprocess_config["mel_channels"]
    mel_f = mel_frequencies(n_mels=n_mels + 2, fmin=preprocess_config["fmin"],
                            fmax=preprocess_config["fmax"])
    dmel = (hz_to_mel(mel_f[-1]) - hz_to_mel(mel_f[0])) / (n_mels - 1)

    ext_low_int = int(np.floor((hz_to_mel(mel_f[0]) - (-dmel)) / dmel))
    ext_low_hz = mel_to_hz(hz_to_mel(mel_f[0]) - ext_low_int * dmel)
    ext_high_int = int(np.ceil(
        (hz_to_mel(dmel + preprocess_config["sample_rate"]) - hz_to_mel(mel_f[-1])) / dmel
    ))
    ext_high_hz = mel_to_hz(hz_to_mel(mel_f[-1]) + ext_high_int * dmel)

    mel_interpolator = mel_filter(
        sr=preprocess_config["sample_rate"], n_fft=n_fft,
        n_mels=n_mels + ext_low_int + ext_high_int,
        fmin=ext_low_hz, fmax=ext_high_hz, norm=False,
    )
    return gain_fac, mel_interpolator, ext_low_int, ext_high_int
