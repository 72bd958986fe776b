"""Export inference weights from a training run's newest checkpoint.

Counterpart of the JAX package's tools/export_from_checkpoint.py, with the
same flags:

    python -m mbexwn_vocoder_torch.cli.export_from_checkpoint --run run/ --model SPEECH [--cargs section:key=value ...]

`cli.train` writes its export (`weights.npz`, `config.yaml`, `weights.step`)
only when its step loop completes; a run that was stopped, or is still
training, has only `checkpoints/<step>/`.  This writes the export from the
newest checkpoint (its parameters, read on the host) so the run can be
loaded by `MELInverter` or exported (cli/export_model.py); `weights.step`
records the checkpoint's step, which the training CLI's no-op replay reads.
`--model` names the config the run was launched with, and `--cargs` the
overrides it was launched with.  Runs no compute on any device.
"""
from __future__ import annotations

import json
import os


def main(run: str, model: str, cargs=None) -> dict:
    from .. import get_config_file
    from ..config import modify_config, read_config
    from ..training.checkpointing import CheckpointManager
    from .train import write_export

    hparams = read_config(get_config_file(model))
    if cargs:
        modify_config(hparams, cargs)
    ckpt_dir = os.path.join(run, hparams["checkpoint_config"].get("checkpoint_dir", "checkpoints"))
    if not os.path.isdir(ckpt_dir):
        raise SystemExit(f"no checkpoints under {run}")
    params, step = CheckpointManager(ckpt_dir).restore_params_only()
    if params is None:
        raise SystemExit(f"no completed checkpoint in {ckpt_dir}")
    write_export(run, params, hparams, step)
    return {"run": run, "exported_step": step}


def cli():
    from argparse import ArgumentParser

    ap = ArgumentParser(description="write a training run's export from its newest checkpoint")
    ap.add_argument("--run", required=True, help="training output dir containing checkpoints/")
    ap.add_argument("--model", required=True, help="registry id / config source the run used")
    ap.add_argument("--cargs", default=None, nargs="+", help="config overrides used at launch")
    args = ap.parse_args()
    print(json.dumps(main(args.run, args.model, args.cargs)))


if __name__ == "__main__":
    cli()
