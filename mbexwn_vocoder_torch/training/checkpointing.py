"""Training checkpoints: save, restore and retention.

Counterpart of the JAX package's training/checkpointing.py, on
`torch.save` / `torch.load(weights_only=True)`.  A checkpoint is the
directory `<checkpoint_dir>/<step>/` holding `state.pt`: the model's
state_dict in the trainable form (`v`, `g`), the optimizer's and the
learning-rate scheduler's state dicts and the step.  It is written under a
temporary name and renamed, so a step directory is complete once it
appears; the newest `max_to_keep` are kept.  A manager does not write a
step again that it saved or restored itself, and refuses to overwrite a
step that another run left there.  `checkpoint_steps` and `latest_step`
read the layout without importing torch.

In a data-parallel run (`group`) every rank calls `save` and `restore`:
rank 0 writes, the others wait at a barrier until the step is complete,
and every rank restores from the shared directory.
"""
from __future__ import annotations

import os
import shutil
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np

_STATE_FILE = "state.pt"


def checkpoint_steps(directory: str) -> List[int]:
    """The steps that have a checkpoint under `directory`, oldest first
    (none when it does not exist)."""
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    return sorted(int(d) for d in names if d.isdigit())


def latest_step(directory: str) -> Optional[int]:
    steps = checkpoint_steps(directory)
    return steps[-1] if steps else None


class CheckpointManager:
    def __init__(self, checkpoint_dir: str, max_to_keep: int = 5, group=None):
        self.directory = os.path.abspath(checkpoint_dir)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.group = group
        self._own = set()  # the steps this manager saved or restored

    def steps(self) -> List[int]:
        """The steps that have a checkpoint, oldest first."""
        return checkpoint_steps(self.directory)

    def latest_step(self) -> Optional[int]:
        return latest_step(self.directory)

    def path(self, step: int) -> str:
        return os.path.join(self.directory, str(step), _STATE_FILE)

    def save(self, step: int, trainer) -> bool:
        """Write `trainer`'s state (anything with `model`, `optimizer`,
        `scheduler` and `step`) as step `step`; False when this manager
        saved or restored that step already.  A checkpoint of the step that
        another run left raises FileExistsError.  With a group, rank 0
        writes and every rank returns once the step is complete."""
        import torch

        if self.group is not None:  # no rank looks before every rank has arrived
            torch.distributed.barrier(group=self.group)
        final = os.path.join(self.directory, str(step))
        if os.path.exists(final):
            if step in self._own:
                return False
            raise FileExistsError(f"checkpoint {final} was not written by this run; "
                                  f"resume from it or train into another checkpoint directory")
        if self.group is None or torch.distributed.get_rank(self.group) == 0:
            payload = {"model": trainer.model.block.state_dict(), "optimizer": trainer.optimizer.state_dict(),
                       "scheduler": trainer.scheduler.state_dict(), "step": int(step)}
            tmp = tempfile.mkdtemp(prefix=f".{step}-", dir=self.directory)
            try:
                torch.save(payload, os.path.join(tmp, _STATE_FILE))
                os.replace(tmp, final)
            finally:
                if os.path.exists(tmp):
                    shutil.rmtree(tmp)
            if self.max_to_keep:
                for old in self.steps()[:-self.max_to_keep]:
                    shutil.rmtree(os.path.join(self.directory, str(old)))
        if self.group is not None:
            torch.distributed.barrier(group=self.group)
        self._own.add(step)
        return True

    def _load(self, step: int) -> Dict:
        import torch

        # on the CPU: load_state_dict moves each tensor to its parameter's
        # device, and keeps the optimizer's step counts on the CPU, as torch.optim does
        return torch.load(self.path(step), map_location="cpu", weights_only=True)

    def restore(self, trainer) -> Optional[int]:
        """Load the newest checkpoint into `trainer` (its model's parameters
        in place, its optimizer and scheduler, its step); returns the step,
        or None when there is no checkpoint."""
        step = self.latest_step()
        if step is None:
            return None
        payload = self._load(step)
        trainer.model.block.load_state_dict(payload["model"], strict=True)
        trainer.optimizer.load_state_dict(payload["optimizer"])
        trainer.scheduler.load_state_dict(payload["scheduler"])
        trainer.step = int(payload["step"])
        self._own.add(step)
        return trainer.step

    def restore_params_only(self) -> Tuple[Optional[Dict[str, np.ndarray]], Optional[int]]:
        """(flat JAX-named host parameters, step) of the newest checkpoint,
        without a model or an optimizer: the parameters as `params_to_jax`
        names them, read on the CPU whatever device saved them."""
        from ..compat.params_io import params_to_jax

        step = self.latest_step()
        if step is None:
            return None, None
        payload = self._load(step)
        return params_to_jax(payload["model"]), int(payload["step"])
