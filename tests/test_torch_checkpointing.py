"""Training checkpoints of the port (`training.checkpointing`): a save and
restore round trip is bit-exact (parameters in the trainable form, Adam's
moments and step counts, the learning-rate schedule's count, the step), the
newest `max_to_keep` are kept, `restore_params_only` gives `params_to_jax`'s
tree without a model, and a restored trainer steps exactly as the one that
was saved.  On the CPU, with the tiny case of `training.parity`."""
import os

import numpy as np
import pytest
import torch

from mbexwn_vocoder_torch.compat.params_io import params_to_jax
from mbexwn_vocoder_torch.models import create_model
from mbexwn_vocoder_torch.training.checkpointing import CheckpointManager
from mbexwn_vocoder_torch.training.parity import tiny_batch, tiny_hparams
from mbexwn_vocoder_torch.training.trainer import Trainer

torch.set_num_threads(2)
SCHEDULE = {"type": "cosine", "warmup_steps": 1, "decay_steps": 10, "final_scale": 0.1}


def _trainer(seed=0):
    hp = tiny_hparams(**{"training_config.lr_schedule": SCHEDULE})
    model, _ = create_model(hp, hp["training_config"], hp["preprocess_config"], trainable=True)
    model.init(torch.Generator().manual_seed(seed))
    return Trainer(model, hp, device="cpu", seed=seed)


def _draws(tr, batch, seed):
    gen = torch.Generator().manual_seed(seed)
    return {k: torch.randn(shape, generator=gen) for k, shape in tr.draw_shapes(batch).items()}


def _state(tr):
    """Everything a checkpoint must carry, as host copies."""
    opt = tr.optimizer.state_dict()
    return {"params": {k: v.detach().clone() for k, v in tr.model.block.state_dict().items()},
            "moments": {(i, name): v.clone() for i, s in opt["state"].items() for name, v in s.items()},
            "groups": [dict(g) for g in opt["param_groups"]],
            "scheduler": {k: v for k, v in tr.scheduler.state_dict().items() if k != "lr_lambdas"},
            "step": tr.step}


def _assert_state_equal(got, ref):
    assert got["step"] == ref["step"] and got["scheduler"] == ref["scheduler"] and got["groups"] == ref["groups"]
    for part in ("params", "moments"):
        assert got[part].keys() == ref[part].keys()
        for k, r in ref[part].items():
            g = got[part][k]
            assert g.dtype == r.dtype and g.shape == r.shape and torch.equal(g, r), (part, k)


@pytest.fixture
def trained(tmp_path_factory):
    """A tiny trainer after two steps, saved at step 2."""
    tr = _trainer()
    batch = tiny_batch()
    for k in range(2):
        tr.train_step(batch, _draws(tr, batch, k))
    ckdir = str(tmp_path_factory.mktemp("ck"))
    assert CheckpointManager(ckdir).save(tr.step, tr)
    return tr, ckdir


def test_save_restore_is_bit_exact(trained):
    tr, ckdir = trained
    fresh = _trainer(seed=5)  # another init, so every parameter must come from the checkpoint
    assert CheckpointManager(ckdir).restore(fresh) == 2
    _assert_state_equal(_state(fresh), _state(tr))
    assert fresh.scheduler.last_epoch == 2 and fresh.optimizer.param_groups[0]["lr"] == tr.optimizer.param_groups[0]["lr"]
    moments = [s for s in fresh.optimizer.state.values()]
    assert moments and all(s["exp_avg"].abs().sum() > 0 for s in moments[:5])


def test_restored_trainer_steps_as_the_saved_one(trained):
    """One more step, same batch and draws: the restored trainer's
    parameters, moments and loss equal the in-memory trainer's."""
    tr, ckdir = trained
    fresh = _trainer(seed=5)
    CheckpointManager(ckdir).restore(fresh)
    batch = tiny_batch(seed=3)
    draws = _draws(tr, batch, 9)
    ref = tr.train_step(batch, draws)
    got = fresh.train_step(batch, draws)
    assert {k: float(v) for k, v in got.items()} == {k: float(v) for k, v in ref.items()}
    _assert_state_equal(_state(fresh), _state(tr))
    assert fresh.step == 3


def test_restore_params_only_is_params_to_jax(trained, tmp_path):
    tr, _ = trained
    ck = CheckpointManager(str(tmp_path / "ck"))
    assert ck.restore_params_only() == (None, None) and ck.restore(_trainer()) is None
    ck.save(tr.step, tr)
    params, step = ck.restore_params_only()
    ref = params_to_jax(tr.model.block.state_dict())
    assert step == tr.step and params.keys() == ref.keys()
    for k, v in ref.items():
        assert isinstance(params[k], np.ndarray) and params[k].dtype == v.dtype and np.array_equal(params[k], v), k
    assert "wavetables" in params and any(k.endswith("/v") for k in params)


def test_retention_and_complete_step_directories(trained, tmp_path):
    tr, _ = trained
    ck = CheckpointManager(str(tmp_path / "ck"), max_to_keep=3)
    os.makedirs(os.path.join(ck.directory, ".99-partial"))  # a save that never completed
    for step in (2, 4, 6, 8, 10):
        assert ck.save(step, tr)
    assert ck.steps() == [6, 8, 10] and ck.latest_step() == 10
    assert not ck.save(10, tr)  # a step that has a checkpoint is not written again
    assert sorted(os.listdir(ck.directory)) == [".99-partial", "10", "6", "8"]
    assert all(os.listdir(os.path.join(ck.directory, str(s))) == ["state.pt"] for s in ck.steps())


def test_a_step_left_by_another_run_is_not_overwritten(trained):
    """A manager does not write a step again that it restored (nothing
    changed), and refuses a step that another manager wrote."""
    tr, ckdir = trained
    fresh = _trainer(seed=5)
    ck = CheckpointManager(ckdir)
    assert ck.restore(fresh) == 2 and not ck.save(2, fresh)
    with pytest.raises(FileExistsError, match="not written by this run"):
        CheckpointManager(ckdir).save(2, fresh)
    saved, ref = torch.load(ck.path(2), weights_only=True)["model"], tr.model.block.state_dict()
    assert saved.keys() == ref.keys() and all(torch.equal(saved[k], v) for k, v in ref.items())


def test_the_layout_is_read_without_torch(tmp_path):
    """`checkpoint_steps` / `latest_step` (the CLI's no-op replay) import
    no torch, and read a missing directory as no checkpoint."""
    import subprocess
    import sys

    for name in ("3", "12", ".5-partial", "notes"):
        os.makedirs(tmp_path / "ck" / name)
    code = ("import sys\n"
            "from mbexwn_vocoder_torch.training.checkpointing import checkpoint_steps, latest_step\n"
            "import mbexwn_vocoder_torch.cli.train\n"
            f"assert checkpoint_steps({str(tmp_path / 'ck')!r}) == [3, 12]\n"
            f"assert latest_step({str(tmp_path / 'ck')!r}) == 12\n"
            f"assert latest_step({str(tmp_path / 'none')!r}) is None\n"
            "assert 'torch' not in sys.modules\n"
            "print('ok')\n")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=repo, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr
