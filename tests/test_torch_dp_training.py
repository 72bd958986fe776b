"""Data-parallel training in the port, on the CPU over gloo.

- One step of the `Trainer` and one of the `AdversarialTrainer` on 2 ranks
  in fp64 (`training.parity.dp_against_single`: the tiny case at a global
  batch of 4 whose shards hold different numbers of voiced frames) equal
  the one-process step on the same global batch, draws and init: every
  metric within 1e-12 relative, every gradient leaf and updated parameter
  within 1e-9 rel-RMS.  The same step under DDP's rule (each rank's own
  loss, gradients averaged) is off by more than 1e-6, so the check sees the
  coupling of the F0 and coherence terms.  With remat_wavenet_blocks the
  2-rank steps equal the one-process step without it, to the same bounds.
- The port's 2-rank step in fp32 against the JAX package's jitted step over
  its virtual 8-device mesh, at a global batch of 8 on the same weights,
  batch and draws: the loss within 2e-5 (the bound tests/test_training.py
  holds JAX DP to against one device).
- The data: the union of two ranks' `SegmentDataset` rows is the
  one-process batch, bit for bit, and each rank extracts features for its
  own rows only.
- The CLI at `--n_devices 2` against `--n_devices 1` (4 steps of the JAX CLI
  test's tiny config, one loader thread, the native loader pinned to one
  worker): the first step's loss within 1e-6 (the same weights, rows and
  draws; only the shards' sums round differently); every step's within
  1e-4.  In fp32 this loss's gradient is determined only to 1e-3 - 1e-2
  (training/parity.py), and Adam's normalised update turns that into
  parameter moves of the learning rate's size on elements whose gradient is
  that small, so later steps drift (the one-process run against itself at
  another thread count shows the same kind of drift in its biases); the
  exact equality of a step is the fp64 test's.  Rank 0 writes one
  checkpoint per save step, the export is the last checkpoint's
  parameters, the run resumes from 4 to 6 on 2 ranks, and a batch that 2
  does not divide raises.
"""
import copy
import functools
import io
import json
import os
from contextlib import redirect_stderr

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import Mesh

from mbexwn_vocoder_tpu.models import create_model as jax_create_model
from mbexwn_vocoder_tpu.training import Trainer as JaxTrainer
from mbexwn_vocoder_tpu.training.trainer import TrainState

import mbexwn_vocoder_torch.cli.train as train_cli
import mbexwn_vocoder_torch.compat.native_loader as port_native
from mbexwn_vocoder_torch.compat.params_io import flatten, load_params, params_from_jax
from mbexwn_vocoder_torch.models import create_model
from mbexwn_vocoder_torch.training import parity
from mbexwn_vocoder_torch.training.checkpointing import CheckpointManager
from mbexwn_vocoder_torch.training.data import SegmentDataset
from mbexwn_vocoder_torch.training.synthetic import make_corpus
from mbexwn_vocoder_torch.training.trainer import Trainer

from tests.test_torch_training import jax_draws
from tests.test_torch_train_cli import CARGS

torch.set_num_threads(2)


# ---- one step, 2 ranks against one process


@pytest.fixture(scope="module")
def dp_fp64():
    return parity.dp_against_single("cpu", world=2)


@pytest.mark.parametrize("what", ["step", "GAN step"])
def test_dp_step_equals_the_one_process_step(dp_fp64, what):
    failures, numbers = dp_fp64
    mine = [f for f in failures if f.startswith(what + " ")]
    assert not mine, mine
    assert numbers[what]["worst_metric_rel"] <= 1e-12 and numbers[what]["worst_leaf_rel_rms"] <= 1e-9
    # the shards differ in what the F0 loss counts
    assert len(set(numbers["voiced_samples_per_shard"])) == 2


@pytest.mark.parametrize("what", ["step", "GAN step"])
def test_a_per_rank_mean_is_not_the_global_step(dp_fp64, what):
    """DDP's rule on the same batch: the F0 loss's voiced-frame weights make
    the mean of the shards' losses another loss."""
    _, numbers = dp_fp64
    n = numbers[what]
    assert n["naive_worst_metric_rel"] > 1e-6 and n["naive_worst_gradient_rel_rms"] > 1e-6, n


def test_dp_step_with_remat_equals_the_one_process_step():
    """remat_wavenet_blocks on 2 gloo ranks (the blocks recomputed in each
    rank's backward pass, the draws injected): the Trainer's and the
    AdversarialTrainer's fp64 steps equal the one-process step without
    remat, every metric within 1e-12 and every gradient leaf and updated
    parameter within 1e-9 rel-RMS."""
    case = dict(parity.tiny_dp_case(), naive=False)
    ref = parity.dp_step(case, "cpu")
    remat = dict(case, hp=copy.deepcopy(case["hp"]))
    remat["hp"]["mbexwn_config"]["remat_wavenet_blocks"] = True
    for rank, out in enumerate(parity.run_dp(remat, "cpu", world=2)):
        for metrics, leaves in (("metrics", ("grads", "params")), ("gan_metrics", ("gan_grads", "gan_params"))):
            got = out["exact"]
            assert got[metrics].keys() == ref[metrics].keys()
            for k in ref[metrics]:
                assert abs(got[metrics][k] / ref[metrics][k] - 1) <= 1e-12, (rank, k, got[metrics][k], ref[metrics][k])
            for key in leaves:
                bad, _ = parity.hold_leaves(got[key], ref[key], 1e-9)
                assert not bad, (rank, key, bad)


def test_dp_step_matches_the_jax_mesh_trainer(monkeypatch):
    hp = parity.tiny_hparams()
    monkeypatch.setenv("MBEXWN_PALLAS_WN", "0")  # the JAX Trainer sets it for the process; gone after the test
    jmodel, _ = jax_create_model(hp, hp["training_config"], hp["preprocess_config"], quiet=True)
    params = jax.jit(lambda k: jmodel.init(k, batch_size=2, T_mel=parity.TINY_T_MEL))(jax.random.PRNGKey(0))
    batch = parity.tiny_dp_batch(seed=4, batch=8)
    model, _ = create_model(hp, hp["training_config"], hp["preprocess_config"], trainable=True)
    model.block.load_state_dict(params_from_jax(flatten(params)), strict=True)
    mesh = Mesh(np.array(jax.devices()[:8]), ("data",))
    jtr = JaxTrainer(jmodel, copy.deepcopy(hp), mesh=mesh)
    state = TrainState(params=params, opt_state=jtr.optimizer.init(params), step=jnp.int32(0))
    key = jax.random.PRNGKey(5)
    case = {"hp": hp, "state": {k: v.numpy() for k, v in model.block.state_dict().items()}, "dtype": "float32",
            "naive": False, "batch": batch, "draws": jax_draws(jtr, key, Trainer(model, hp, device="cpu").draw_shapes(batch))}
    with mesh:  # the jitted step donates the state: it runs last
        _, j_metrics = jtr.jitted_train_step()(state, {k: jnp.asarray(v) for k, v in batch.items()}, key)
    ranks = parity.run_dp(case, "cpu", world=2)
    got = ranks[0]["exact"]["metrics"]
    assert ranks[1]["exact"]["metrics"] == got
    for name in ("total_loss", "F0_loss", "stft_coh_loss"):
        assert abs(got[name] / float(j_metrics[name]) - 1) <= 2e-5, (name, got[name], float(j_metrics[name]))


# ---- the data


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("corpus")
    make_corpus(str(d), n_utterances=3, seed=1, duration_range=(1.0, 1.5), quiet=True)
    return str(d)


def _preprocess_config():
    from mbexwn_vocoder_torch import get_config_file
    from mbexwn_vocoder_torch.config import read_config

    pc = read_config(get_config_file("SPEECH"))["preprocess_config"]
    return dict(pc, segment_length=6000)


def test_rank_shards_make_the_one_process_batch(corpus, monkeypatch):
    """Steps 0 and 1 of the Python sampler, batch 4: rank r's rows are rows
    2r and 2r + 1 of the one-process batch, and it extracts features for
    those 2 only."""
    pc = _preprocess_config()
    extracted = []
    features = SegmentDataset._features

    def counting(self, seg):
        extracted.append(self.rank)
        return features(self, seg)

    monkeypatch.setattr(SegmentDataset, "_features", counting)
    one = SegmentDataset(corpus, pc, seed=3, use_native=False)
    ranks = [SegmentDataset(corpus, pc, seed=3, use_native=False, shard=(r, 2)) for r in range(2)]
    for _ in range(2):
        ref = one.batch(4)
        extracted.clear()
        parts = [ds.batch(4) for ds in ranks]
        assert extracted == [0, 0, 1, 1]
        for k in ref:
            np.testing.assert_array_equal(np.concatenate([p[k] for p in parts]), ref[k])
    with pytest.raises(ValueError, match="divisible"):
        ranks[0].batch(3)


def test_rank_shards_of_the_native_stream(corpus, monkeypatch):
    """A sharded dataset pins the native loader to one worker: the union of
    the ranks' rows is the one-process batch of a one-worker loader."""
    if not port_native.available():
        pytest.skip(f"no native segment loader: {port_native.load_error()}")
    pc = _preprocess_config()
    one_worker = functools.partial(port_native.NativeSegmentLoader, n_workers=1)
    monkeypatch.setattr(port_native, "NativeSegmentLoader", one_worker)
    one = SegmentDataset(corpus, pc, seed=3)
    monkeypatch.undo()
    ranks = [SegmentDataset(corpus, pc, seed=3, shard=(r, 2)) for r in range(2)]
    try:
        assert one.source == "native" and all(ds.source == "native" for ds in ranks)
        for _ in range(2):
            ref = one.batch(4)
            parts = [ds.batch(4) for ds in ranks]
            for k in ref:
                np.testing.assert_array_equal(np.concatenate([p[k] for p in parts]), ref[k])
    finally:
        for ds in [one] + ranks:
            ds.close()


# ---- the CLI


def _train(data_dir, out_dir, steps, n_devices, **kw):
    """main()'s numbers (rank 0's); the ranks' own stderr is not captured."""
    with redirect_stderr(io.StringIO()):
        return train_cli.main("SPEECH", data_dir, out_dir, steps=steps, **{
            **dict(batch_size=2, save_every=2, log_every=1, cargs=CARGS, num_workers=1, n_devices=n_devices), **kw})


def _losses(out_dir):
    return {r["step"]: r["total_loss"] for r in map(json.loads, open(os.path.join(out_dir, "logs", "metrics.jsonl")))}


@pytest.fixture(scope="module")
def cli_runs(tmp_path_factory):
    """--n_devices 1 and 2 for 4 steps, then the 2-rank run resumed to 6
    (given --init_from too, which the checkpoint wins over), its replay,
    and a 2-rank warm start from the one-rank run's export."""
    mp = pytest.MonkeyPatch()
    mp.setenv("MBEXWN_PLATFORM", "cpu")
    # the one-process run's native loader as a rank's: one worker, a fixed stream
    mp.setattr(port_native, "NativeSegmentLoader", functools.partial(port_native.NativeSegmentLoader, n_workers=1))
    root = tmp_path_factory.mktemp("dp_cli")
    data = str(root / "data")
    make_corpus(data, n_utterances=2, seed=0, duration_range=(1.0, 1.5), quiet=True)
    try:
        one = _train(data, str(root / "one"), 4, 1)
        two = _train(data, str(root / "two"), 4, 2)
        two_losses = _losses(str(root / "two"))
        weights = str(root / "one" / "weights.npz")
        resumed = _train(data, str(root / "two"), 6, 2, init_from=weights)
        replay = _train(data, str(root / "two"), 6, 2)
        warm = _train(data, str(root / "warm"), 5, 2, init_from=weights, init_step=4)
    finally:
        mp.undo()
    return {"root": root, "data": data, "one": one, "two": two, "two_losses": two_losses, "resumed": resumed,
            "replay": replay, "warm": warm}


def test_cli_losses_follow_the_one_process_run(cli_runs):
    one, two = _losses(str(cli_runs["root"] / "one")), cli_runs["two_losses"]
    assert sorted(one) == sorted(two) == [1, 2, 3, 4]
    assert abs(two[1] / one[1] - 1) <= 1e-6, (two[1], one[1])
    for step in one:
        assert abs(two[step] / one[step] - 1) <= 1e-4, (step, two[step], one[step])
    assert cli_runs["one"]["world_size"] == 1 and cli_runs["two"]["world_size"] == 2
    assert cli_runs["two"]["device"] == "cpu"


def test_cli_rank_0_writes_one_checkpoint_per_save_and_the_export(cli_runs):
    out = str(cli_runs["root"] / "two")
    ckpt = CheckpointManager(os.path.join(out, "checkpoints"))
    assert ckpt.steps() == [2, 4, 6]
    assert sorted(os.listdir(os.path.join(out, "checkpoints"))) == ["2", "4", "6"]  # no leftover temporaries
    assert [c["step"] for c in cli_runs["two"]["checkpoints"]] == [2, 4]
    flat, step = ckpt.restore_params_only()
    export = flatten(load_params(os.path.join(out, "weights.npz")))
    assert step == 6 and open(os.path.join(out, "weights.step")).read().strip() == "6"
    assert flat.keys() == export.keys() and all(np.array_equal(flat[k], export[k]) for k in flat)
    # one metrics record per step: rank 0's
    assert [json.loads(line)["step"] for line in open(os.path.join(out, "logs", "metrics.jsonl"))] == [1, 2, 3, 4,
                                                                                                      5, 6]


def test_cli_resumes_replays_and_warm_starts_on_two_ranks(cli_runs):
    resumed, warm = cli_runs["resumed"], cli_runs["warm"]
    assert resumed["resumed"] and not resumed["warm_started"]
    assert resumed["start_step"] == 4 and resumed["end_step"] == 6
    assert cli_runs["replay"] is None  # the target reached and exported: nothing spawned
    assert warm["warm_started"] and warm["world_size"] == 2 and warm["start_step"] == 4 and warm["end_step"] == 5
    losses = _losses(str(cli_runs["root"] / "warm"))  # one step from the one-rank run's export, at step 5
    assert list(losses) == [5] and np.isfinite(losses[5])
    assert sorted(_losses(str(cli_runs["root"] / "two"))) == [1, 2, 3, 4, 5, 6]


def test_cli_fails_when_a_rank_fails(tmp_path, monkeypatch):
    """Both ranks raise (no wav under the data directory): the CLI raises."""
    monkeypatch.setenv("MBEXWN_PLATFORM", "cpu")
    os.makedirs(tmp_path / "empty")
    with pytest.raises(RuntimeError, match="exited non-zero"):
        _train(str(tmp_path / "empty"), str(tmp_path / "run"), 1, 2)


def test_cli_refuses_a_batch_the_ranks_do_not_divide(cli_runs, tmp_path, monkeypatch):
    monkeypatch.setenv("MBEXWN_PLATFORM", "cpu")
    with pytest.raises(RuntimeError, match="batch_size 3 must be divisible by n_devices 2"):
        train_cli.main("SPEECH", cli_runs["data"], str(tmp_path), steps=1, batch_size=3, cargs=CARGS, n_devices=2)
    assert not os.listdir(tmp_path)

