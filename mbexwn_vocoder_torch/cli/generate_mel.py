"""CLI: audio file(s) -> `.mell` pickle mel analyses (host NumPy).

Counterpart of the JAX package's cli/generate_mel.py, with the same flags
and the same `.mell` dict schema:

    python -m mbexwn_vocoder_torch.cli.generate_mel a.wav b.wav -o meldir [--model_id SPEECH]

The analysis runs on the host only; no device is touched.
"""
from __future__ import annotations

import os
import sys

import numpy as np


def main(input_audio_files, output_dir, model_id="VOICE"):
    from .. import get_config_file
    from ..analysis import compute_mel_spectrogram_internal
    from ..compat import iovar
    from ..compat.audio_io import read_wav
    from ..config import read_config
    from ..dsp.resample import resample

    config_file = get_config_file(model_id_or_path=model_id)
    hparams = read_config(config_file)
    preprocess_config = hparams["preprocess_config"]

    if output_dir and not os.path.exists(output_dir):
        os.makedirs(output_dir)

    data_dict = {
        "nfft": preprocess_config["fft_size"],
        "hoplen": preprocess_config["hop_size"],
        "winlen": preprocess_config["win_size"],
        "nmels": preprocess_config["mel_channels"],
        "sr": preprocess_config["sample_rate"],
        "fmin": preprocess_config["fmin"],
        "fmax": preprocess_config["fmax"],
        "lin_spec_offset": preprocess_config["lin_amp_off"],
        "lin_spec_scale": preprocess_config["lin_amp_scale"],
        "log_spec_offset": 0.0,
        "log_spec_scale": preprocess_config["mel_amp_scale"],
        "time_axis": 1,
    }

    for audio_file in input_audio_files:
        print(f"process {audio_file}", file=sys.stderr)
        snd, sr = read_wav(audio_file)
        if sr != preprocess_config["sample_rate"]:
            snd, _ = resample(snd, sr, preprocess_config["sample_rate"], axis=0)
        mel_ref, *rest = compute_mel_spectrogram_internal(
            snd, preprocess_config=preprocess_config, band_limit=None, dtype=np.float32, do_post=False
        )
        data_dict["mell"] = mel_ref[0].T
        out = os.path.join(output_dir, os.path.splitext(os.path.basename(audio_file))[0] + ".mell")
        iovar.save_var(out, data_dict)


def cli():
    from argparse import ArgumentParser

    parser = ArgumentParser(description="create mel analyses from sound files")
    parser.add_argument("input_audio_files", nargs="+", help="input files to process")
    parser.add_argument("-o", "--output_dir", required=True, help="output directory for .mell files")
    parser.add_argument("--model_id", default="VOICE", nargs="?", const="",
                        help="model id used to read the mel analysis configuration")
    args = parser.parse_args()
    main(**vars(args))


if __name__ == "__main__":
    cli()
