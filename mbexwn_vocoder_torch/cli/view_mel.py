"""CLI: visualize / diff mel spectrograms from audio or `.mell` files (host NumPy).

Counterpart of the JAX package's cli/view_mel.py, with the same flags:
per-file statistics, `-d` the mel-L1 difference of the first two inputs,
`-o` a PNG, `--show` an interactive window.

    python -m mbexwn_vocoder_torch.cli.view_mel --infiles a.wav b.mell -d -o mel.png

matplotlib is imported only when a plot is asked for.  No device is touched.
"""
from __future__ import annotations

import os
import sys

import numpy as np


def _load_mel(infile, preprocess_config, noise_mask_atten_db=None):
    from ..analysis import compute_mel_spectrogram_internal
    from ..compat import iovar
    from ..compat.audio_io import read_wav
    from ..dsp.resample import resample

    if infile.endswith(".mell") or infile.endswith(".mell.gz") or infile.endswith(".p"):
        dd = iovar.load_var(infile)
        mell = dd["mell"] if "mell" in dd else np.log(np.fmax(dd["mel"], 1e-10))
        if dd.get("time_axis", 1) == 1:
            mell = mell.T  # -> (T, n_mels)... stored (n_mels, T) with time_axis=1 meaning dict mell is C x T
        return np.asarray(mell, dtype=np.float32), dd.get("sr", preprocess_config["sample_rate"])
    snd, sr = read_wav(infile)
    if sr != preprocess_config["sample_rate"]:
        snd, _ = resample(snd, sr, preprocess_config["sample_rate"], axis=0)
    if noise_mask_atten_db is not None:
        # masking noise before analysis (reference bin/view_mel.py:99-100):
        # reveals which mel structure survives a given noise floor
        snd = snd + 10 ** (-noise_mask_atten_db / 20) * np.sqrt(np.mean(snd * snd)) \
            * np.random.standard_normal(snd.shape).astype(snd.dtype)
    mell, _ = compute_mel_spectrogram_internal(snd, preprocess_config=preprocess_config, do_post=False)
    return mell[0], preprocess_config["sample_rate"]


def main(infiles, model_id="VOICE", output=None, diff_mel=False, max_atten=50, cargs=None,
         noise_mask_atten_db=None, plot_snds=False, show=False):
    from .. import get_config_file
    from ..config import modify_config, read_config
    from ..dsp.db import log_to_db

    hparams = read_config(get_config_file(model_id))
    if cargs:
        modify_config(hparams, cargs)
    preprocess_config = hparams["preprocess_config"]

    mels = []
    snds = {}
    for f in infiles:
        mell, sr = _load_mel(f, preprocess_config, noise_mask_atten_db=noise_mask_atten_db)
        if plot_snds and not (f.endswith(".mell") or f.endswith(".mell.gz") or f.endswith(".p")):
            from ..compat.audio_io import read_wav

            snds[f] = read_wav(f)[0]
        mels.append((f, mell))
        mdb = log_to_db * mell
        print(
            f"{f}: frames={mell.shape[0]} bands={mell.shape[1]} "
            f"max={np.max(mdb):.1f}dB mean={np.mean(mdb):.1f}dB min={np.min(mdb):.1f}dB",
            file=sys.stderr,
        )

    if diff_mel and len(mels) >= 2:
        T = min(m.shape[0] for _, m in mels)
        d = log_to_db * np.mean(np.abs(mels[0][1][:T] - mels[1][1][:T]))
        print(f"mel-L1 diff {mels[0][0]} vs {mels[1][0]}: {d:.3f} dB")

    if show and not (os.environ.get("DISPLAY") or sys.platform == "darwin"):
        print("view_mel: no display available, falling back to stats"
              + (" + PNG" if output else " (pass -o to render a PNG)"), file=sys.stderr)
        show = False

    if output or show:
        import matplotlib

        if not show:  # interactive backend stays default when displaying
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        n = len(mels) + (1 if (diff_mel and len(mels) >= 2) else 0) + (len(snds) if plot_snds else 0)
        # sharex: every panel (mels, waveforms, diff) rides the same seconds
        # axis, so interactive zoom/pan stays synchronized across files — the
        # comparison affordance of the reference viewer (bin/view_mel.py:43-162)
        fig, axes = plt.subplots(n, 1, figsize=(10, 3 * n), squeeze=False, sharex=True)
        sr = preprocess_config["sample_rate"]
        frame_s = preprocess_config["hop_size"] / sr
        for i, (f, mell) in enumerate(mels):
            mdb = log_to_db * mell.T
            vmax = np.max(mdb)
            im = axes[i][0].imshow(mdb, origin="lower", aspect="auto",
                                   vmin=vmax - max_atten, vmax=vmax,
                                   extent=(0.0, mell.shape[0] * frame_s, 0, mell.shape[1]))
            axes[i][0].set_title(os.path.basename(f))
            axes[i][0].set_ylabel("mel band")
            fig.colorbar(im, ax=axes[i][0], label="dB")
        row = len(mels)
        if plot_snds:
            # waveform panels (reference bin/view_mel.py:116-146 second figure)
            for f, snd in snds.items():
                axes[row][0].plot(np.arange(snd.shape[0]) / sr, snd)
                axes[row][0].set_title(f"snd {os.path.basename(f)}")
                row += 1
        if diff_mel and len(mels) >= 2:
            T = min(m.shape[0] for _, m in mels)
            dd = log_to_db * (mels[0][1][:T] - mels[1][1][:T]).T
            im = axes[row][0].imshow(dd, origin="lower", aspect="auto",
                                     extent=(0.0, T * frame_s, 0, dd.shape[0]))
            axes[row][0].set_title("diff (dB)")
            fig.colorbar(im, ax=axes[row][0], label="dB")
        axes[-1][0].set_xlabel("time (s)")
        fig.tight_layout()
        if output:
            fig.savefig(output)
            print(f"wrote {output}", file=sys.stderr)
        if show:
            # interactive display (reference bin/view_mel.py:43-162 behavior)
            plt.show()


def cli():
    from argparse import ArgumentParser

    parser = ArgumentParser(description="view/diff mel spectrograms from audio or .mell files")
    parser.add_argument("--infiles", nargs="+", required=True)
    parser.add_argument("--model_id", default="VOICE", nargs="?", const="")
    parser.add_argument("-o", "--output", default=None, help="write a PNG instead of just stats")
    parser.add_argument("-d", "--diff_mel", action="store_true")
    parser.add_argument("-r", "--max_atten", default=50, type=int)
    parser.add_argument("-a", "--cargs", default=None, nargs="+",
                        help="config overrides with ':' as field separator")
    parser.add_argument("-n", "--noise_mask_atten_db", default=None, type=float,
                        help="masking noise added before calculating the mel spectrum")
    parser.add_argument("-ps", "--plot_snds", action="store_true",
                        help="also plot the waveforms of audio inputs")
    parser.add_argument("--show", action="store_true",
                        help="open an interactive matplotlib window (needs a display; "
                             "falls back to stats/PNG when headless)")
    args = parser.parse_args()
    main(**vars(args))


if __name__ == "__main__":
    cli()
