"""CLI: `.mell` mel pickles -> resynthesized audio, on the card.

Counterpart of the JAX package's cli/resynth_mel.py, with the same flags and
the same verbose round-trip mel-error report.

    python -m mbexwn_vocoder_torch.cli.resynth_mel SPEECH -i a.mell b.mell -o outdir [-v]
        [--pipeline DEPTH [--batch B]] [--precision quality|fast|default] [-nt N]

It runs on the card; `MBEXWN_PLATFORM=cpu` runs it on the CPU.  Without a
model id it lists the registry's models.
"""
from __future__ import annotations

import os
import sys
import time

import numpy as np


def _outfile(output_dir, mell_file, format):
    return os.path.join(output_dir, "syn_" + os.path.splitext(os.path.basename(mell_file))[0] + "." + format)


def _mel_error_db(MelInv, log_mel_spectrogram, syn_audio):
    """The mean |log-mel| error in dB of the synthesis' own mel analysis."""
    from ..dsp.db import log_to_db

    mel_resyn = MelInv.generate_mel_from_snd(syn_audio, srate=MelInv.srate)["mell"].T[np.newaxis]
    return log_to_db * np.mean(np.abs(log_mel_spectrogram - mel_resyn[:, : log_mel_spectrogram.shape[1]]))


def _warn_clipping(syn_audio, outfile):
    if np.max(np.abs(syn_audio)) > 1:
        norm = 0.99 / np.max(np.abs(syn_audio))
        print(f"    to prevent clipping you would need to normalize {outfile} by {norm:.3f}", file=sys.stderr)


def main(model_id, input_mell_files, output_dir, format="wav", verbose=False, quiet=False, batch=8, pipeline=0,
         device=None):
    """Synthesize every file of `input_mell_files` into `output_dir`; with
    `pipeline` > 0 through a `pipeline`-deep PipelinedSynthesizer that
    micro-batches up to `batch` files.  `device` None: MBEXWN_PLATFORM."""
    from ..compat import iovar
    from ..compat.audio_io import write_wav
    from ..mel_inverter import MELInverter
    from ..platform import platform_device

    MelInv = MELInverter(model_id_or_path=model_id, verbose=verbose,
                         device=platform_device() if device is None else device)

    if output_dir and not os.path.exists(output_dir):
        os.makedirs(output_dir)

    if pipeline:
        _main_pipelined(MelInv, input_mell_files, output_dir, format, verbose, quiet, depth=pipeline, batch=batch)
        return

    for mell_file in input_mell_files:
        outfile = _outfile(output_dir, mell_file, format)
        if not quiet:
            print(f"synthesize {mell_file} into {outfile}", file=sys.stderr)

        dd = iovar.load_var(mell_file)
        log_mel_spectrogram = MelInv.scale_mel(dd, verbose=verbose)

        start_time = time.time()
        syn_audio = MelInv.synth_from_mel(log_mel_spectrogram)
        end_time = time.time()

        if verbose:
            mell_err = _mel_error_db(MelInv, log_mel_spectrogram, syn_audio)
            print(f"    synthesized audio with {syn_audio.size} samples in {end_time - start_time:.3f}s "
                  f"({syn_audio.size / (end_time - start_time):.2f}Hz), mel_error: {mell_err:.3f}dB",
                  file=sys.stderr)
        _warn_clipping(syn_audio, outfile)
        write_wav(outfile, syn_audio, MelInv.srate)


def _main_pipelined(MelInv, input_mell_files, output_dir, format, verbose, quiet, depth, batch=1):
    """Depth-bounded pipelined serving loop: the card's synthesis of later
    files overlaps the readback, mel check and wav write of earlier ones;
    with batch > 1, same-bucket files also micro-batch into one dispatch."""
    from ..compat import iovar
    from ..compat.audio_io import write_wav
    from ..serving import PipelinedSynthesizer

    ps = PipelinedSynthesizer(MelInv.model, length_buckets=MelInv.length_buckets, depth=depth, batch=batch,
                              device=MelInv.device)
    outfiles = [_outfile(output_dir, f, format) for f in input_mell_files]
    mels = [MelInv.scale_mel(iovar.load_var(f), verbose=verbose) for f in input_mell_files]

    start_time = time.time()
    for i, syn_audio in enumerate(ps.stream(m for m in mels)):
        if not quiet:
            print(f"synthesize {input_mell_files[i]} into {outfiles[i]}", file=sys.stderr)
        if verbose:
            print(f"    mel_error: {_mel_error_db(MelInv, mels[i], syn_audio):.3f}dB", file=sys.stderr)
        _warn_clipping(syn_audio, outfiles[i])
        write_wav(outfiles[i], syn_audio, MelInv.srate)
    if not quiet:
        dur = time.time() - start_time
        n = sum(m.shape[1] for m in mels) * MelInv.hop_size
        print(f"pipelined {len(mels)} files ({n} samples) in {dur:.3f}s ({n / dur:.2f}Hz, depth {depth})",
              file=sys.stderr)


def apply_precision(precision):
    """Map the --precision choice onto the compute-dtype env knobs.

    Must run before the model is constructed; an EMPTY value forces fp32
    (models/mbexwn.py::_dtype_pref).  setdefault keeps the documented
    precedence: an explicitly exported MBEXWN_*_DTYPE always wins.
    """
    if precision == "default":
        return
    val = "" if precision == "quality" else "bfloat16"
    os.environ.setdefault("MBEXWN_WN_DTYPE", val)
    os.environ.setdefault("MBEXWN_SUBNET_DTYPE", val)


def cli():
    from argparse import ArgumentParser

    from .. import list_models

    parser = ArgumentParser(description="resynthesize audio from mel spectrograms")
    parser.add_argument("model_id", default=None, nargs="?", const=None,
                        help="model identifier (substring match); omit to list models")
    parser.add_argument("-i", "--input_mell_files", nargs="+", help="mell spectra pickle files")
    parser.add_argument("-o", "--output_dir", help="output directory")
    parser.add_argument("--format", default="wav", help="audio format (wav)")
    parser.add_argument("-v", "--verbose", action="store_true")
    parser.add_argument("-q", "--quiet", action="store_true")
    parser.add_argument("-g", "--use_gpu", action="store_true",
                        help="accepted for reference-CLI compatibility (synthesis runs on the card; "
                             "MBEXWN_PLATFORM=cpu runs it on the CPU)")
    parser.add_argument("--pipeline", type=int, default=0, metavar="DEPTH",
                        help="serve files through a DEPTH-deep pipeline (overlaps the card's synthesis "
                             "with readback and writes)")
    parser.add_argument("--batch", type=int, default=8, metavar="B",
                        help="with --pipeline: micro-batch up to B consecutive same-length-bucket files "
                             "into one device batch; coalescing is on by default, --batch 1 opts out")
    parser.add_argument("-nt", "--cpu_threads", "--num_threads", type=int, default=None,
                        help="bound the host's CPU threads (torch.set_num_threads)")
    parser.add_argument("--precision", choices=("quality", "fast", "default"), default="default",
                        help="compute precision: 'quality' forces fp32 everywhere, 'fast' forces bf16, "
                             "'default' uses the model config (env MBEXWN_WN_DTYPE/MBEXWN_SUBNET_DTYPE "
                             "still wins)")
    args = parser.parse_args()
    apply_precision(args.precision)
    if args.cpu_threads is not None:
        import torch

        torch.set_num_threads(args.cpu_threads)
    for key in ("precision", "cpu_threads", "use_gpu"):
        delattr(args, key)

    if not args.model_id:
        print("Please select one of the following models for mel inversion:")
        for kk, ll in list_models().items():
            for md in ll:
                print(f" - {kk}/{md}")
    else:
        main(**vars(args))


if __name__ == "__main__":
    cli()
