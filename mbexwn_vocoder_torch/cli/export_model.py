"""CLI: AOT-export a model to a self-contained serving artifact.

Counterpart of the JAX package's cli/export_model.py, with the same flags:

    python -m mbexwn_vocoder_torch.cli.export_model --model SPEECH -o speech.pt2aot -T 512 [-b B] [-p cuda cpu] [-v]

The model is loaded on the device `MBEXWN_PLATFORM` names (the card unless
it says cpu), or on the first platform `-p` names.  The artifact runs with
this package's kernel ops alone (compat/export.py):

    from mbexwn_vocoder_torch.compat.export import synth_from_artifact
    wav = synth_from_artifact("speech.pt2aot", mel)   # (B, T_mel, 80) float32
"""
from __future__ import annotations

import sys


def main(model, output, t_mel, batch_size=1, platforms=None, verbose=False):
    from ..compat.export import export_model_dir

    meta = export_model_dir(model, output, T_mel=t_mel, batch_size=batch_size, platforms=platforms,
                            verbose=verbose)
    print(f"wrote {output}: {meta['bytes']} bytes, platforms={meta['platforms']}, "
          f"input=({meta['batch_size']}, {meta['T_mel']}, {meta['mel_channels']}) "
          f"-> {meta['T_mel'] * meta['hop_size']} samples @ {meta['sample_rate']} Hz, "
          f"WaveNet {meta['wn_dtype']}, subnets {meta['subnet_dtype']}", file=sys.stderr)
    return meta


def cli():
    from argparse import ArgumentParser

    p = ArgumentParser(description="export a model as a self-contained AOT serving artifact")
    p.add_argument("--model", required=True, help="model id or model directory")
    p.add_argument("-o", "--output", required=True)
    p.add_argument("-T", "--t_mel", type=int, required=True, help="mel frames per call")
    p.add_argument("-b", "--batch_size", type=int, default=1)
    p.add_argument("-p", "--platforms", nargs="+", default=None,
                   help="platforms to store a program for, e.g. cuda cpu (default: the MBEXWN_PLATFORM device)")
    p.add_argument("-v", "--verbose", action="store_true")
    a = p.parse_args()
    main(a.model, a.output, a.t_mel, a.batch_size, a.platforms, a.verbose)


if __name__ == "__main__":
    cli()
