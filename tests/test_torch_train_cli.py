"""The port's training CLI (`cli.train`) on the CPU, with the JAX
package's own CLI test settings (tests/test_train_pipeline.py: SPEECH with
a 16-channel, 2-layer WaveNet, 6000-sample segments, batch 2), and the
pieces it shares with the JAX package: `dump_config` and the config
validators, `MetricsLogger`, `model_summary` and `check_finite`.

The CLI trains 4 steps and resumes to 6 (`MBEXWN_PLATFORM=cpu`); metrics
are finite with the JAX CLI's keys; a replay of a reached target builds no
model, but not with `--init_from` nor with a stale export; the export loads
in both packages' `MELInverter`, which synthesise the same audio in fp32
within 1e-3 rel-RMS given the JAX package's noise draw.
"""
import copy
import io
import json
import os
import shutil
from contextlib import redirect_stderr

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mbexwn_vocoder_tpu.config.config_utils as jax_cutils
import mbexwn_vocoder_tpu.observability as jax_obs
from mbexwn_vocoder_tpu.mel_inverter import MELInverter as JaxMELInverter
from mbexwn_vocoder_tpu.models import create_model as jax_create_model
from mbexwn_vocoder_tpu.training import Trainer as JaxTrainer

import mbexwn_vocoder_torch.cli.train as train_cli
import mbexwn_vocoder_torch.config.config_utils as cutils
from mbexwn_vocoder_torch import get_config_file
from mbexwn_vocoder_torch.compat.params_io import flatten, load_params
from mbexwn_vocoder_torch.mel_inverter import MELInverter
from mbexwn_vocoder_torch.models import create_model
from mbexwn_vocoder_torch.observability import MetricsLogger, check_finite, model_summary
from mbexwn_vocoder_torch.training.checkpointing import CheckpointManager
from mbexwn_vocoder_torch.training.parity import rel_rms
from mbexwn_vocoder_torch.training.synthetic import make_corpus

torch.set_num_threads(2)
CARGS = [
    "mbexwn_config:pp_mod_subnet:n_channels=16",
    "mbexwn_config:pp_mod_subnet:n_layers=2",
    "mbexwn_config:pp_mod_subnet:n_out_channels=8",
    "mbexwn_config:normalize_rms_from_mell=False",
    "preprocess_config:segment_length=6000",
]
RUN = dict(batch_size=2, save_every=2, log_every=1, cargs=CARGS, num_workers=1)


def _train(data_dir, out_dir, steps, **kw):
    """main() with its stderr; returns (its result, the stderr text)."""
    buf = io.StringIO()
    with redirect_stderr(buf):
        result = train_cli.main("SPEECH", data_dir, out_dir, steps=steps, **{**RUN, **kw})
    return result, buf.getvalue()


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    make_corpus(str(d), n_utterances=2, seed=0, duration_range=(1.0, 1.5), quiet=True)
    return str(d)


@pytest.fixture(scope="module")
def run(tmp_path_factory, data_dir):
    """4 steps, then a resumed leg to 6, on the CPU (MBEXWN_PLATFORM)."""
    mp = pytest.MonkeyPatch()
    mp.setenv("MBEXWN_PLATFORM", "cpu")
    out = str(tmp_path_factory.mktemp("run"))
    try:
        first, err1 = _train(data_dir, out, 4)
        second, err2 = _train(data_dir, out, 6)
    finally:
        mp.undo()
    return {"dir": out, "first": first, "second": second, "stderr": (err1, err2)}


def _tiny_hparams():
    hp = cutils.read_config(get_config_file("SPEECH"))
    cutils.modify_config(hp, CARGS)
    return hp


def _copy_run(run, tmp_path):
    out = str(tmp_path / "run")
    shutil.copytree(run["dir"], out)
    return out


def test_metrics_are_finite_with_the_jax_cli_keys(run, monkeypatch):
    recs = [json.loads(line) for line in open(os.path.join(run["dir"], "logs", "metrics.jsonl"))]
    assert [r["step"] for r in recs] == [1, 2, 3, 4, 5, 6]
    assert all(np.isfinite(v) for r in recs for v in r.values())
    # the metrics the JAX CLI logs: its Trainer.loss_fn's, traced on the same config (no compile)
    hp = _tiny_hparams()
    monkeypatch.setenv("MBEXWN_PALLAS_WN", "0")  # the JAX Trainer sets it for the process; gone after the test
    jmodel, _ = jax_create_model(hp, hp["training_config"], hp["preprocess_config"], quiet=True)
    params = jax.eval_shape(lambda k: jmodel.init(k, batch_size=2, T_mel=21), jax.random.PRNGKey(0))
    batch = {"audio": jnp.zeros((2, 6000)), "mel": jnp.zeros((2, 21, 80)), "F0_ds": jnp.zeros((2, 3000))}
    _, j_metrics = jax.eval_shape(JaxTrainer(jmodel, hp).loss_fn, params, batch, jnp.int32(0), jax.random.PRNGKey(1))
    assert all(set(r) == {"step", "time"} | set(j_metrics) for r in recs)
    assert run["first"]["start_step"] == 0 and run["second"]["start_step"] == 4 and run["second"]["resumed"]
    assert "resumed from step 4" in run["stderr"][1]


def test_checkpoints_and_export(run):
    out = run["dir"]
    assert CheckpointManager(os.path.join(out, "checkpoints")).steps() == [2, 4, 6]
    assert train_cli.export_step(out) == 6
    params, step = CheckpointManager(os.path.join(out, "checkpoints")).restore_params_only()
    exported = flatten(load_params(os.path.join(out, "weights.npz")))
    assert step == 6 and params.keys() == exported.keys()
    assert all(np.array_equal(params[k], v) for k, v in exported.items())
    assert [c["step"] for c in run["first"]["checkpoints"]] == [2, 4]
    assert all(c["bytes"] > 0 for c in run["first"]["checkpoints"])
    assert run["first"]["loader"]["batches_made"] >= 4


def test_replay_of_a_reached_target_builds_no_model(run, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("the no-op replay built a model")

    monkeypatch.setattr("mbexwn_vocoder_torch.models.factory.create_model", refuse)
    result, err = _train(run["dir"], run["dir"], 6)
    assert result is None and "nothing to train" in err and f"exported inference model to {run['dir']}" in err


def test_init_from_never_takes_the_no_op_path(run, data_dir, tmp_path, monkeypatch):
    """With --init_from the replay builds the model; the checkpoint wins
    over the warm start, and nothing is left to train."""
    monkeypatch.setenv("MBEXWN_PLATFORM", "cpu")
    out = _copy_run(run, tmp_path)
    result, err = _train(data_dir, out, 6, init_from=os.path.join(out, "weights.npz"))
    assert "nothing to train" not in err and "resumed from step 6" in err
    assert result["resumed"] and not result["warm_started"] and result["end_step"] == 6 and not result["step_host_s"]


def test_a_stale_export_is_made_again(run, data_dir, tmp_path, monkeypatch):
    """An export whose recorded step is not the newest checkpoint's (a leg
    that stopped between its last checkpoint and its export) is not taken
    as done: the replay restores and exports again."""
    monkeypatch.setenv("MBEXWN_PLATFORM", "cpu")
    out = _copy_run(run, tmp_path)
    with open(os.path.join(out, train_cli.EXPORT_STEP_FILE), "w") as f:
        f.write("4\n")
    os.utime(os.path.join(out, "weights.npz"), (0, 0))
    result, err = _train(data_dir, out, 6)
    assert "nothing to train" not in err and "resumed from step 6" in err
    assert train_cli.export_step(out) == 6 and os.path.getmtime(os.path.join(out, "weights.npz")) > 0


def test_no_resume_refuses_a_directory_with_checkpoints(run, data_dir, tmp_path, monkeypatch):
    """--no_resume into a run directory with checkpoints raises before it
    trains: its states beside the earlier run's would let a later replay
    or resume take the earlier run's.  The directory is left as it was."""
    monkeypatch.setenv("MBEXWN_PLATFORM", "cpu")
    out = _copy_run(run, tmp_path)
    before = {name: os.path.getmtime(os.path.join(out, name)) for name in ("weights.npz", train_cli.EXPORT_STEP_FILE)}
    with pytest.raises(FileExistsError, match=r"--no_resume: .* \(newest step 6\)"):
        _train(data_dir, out, 4, resume=False)
    assert CheckpointManager(os.path.join(out, "checkpoints")).steps() == [2, 4, 6]
    assert {name: os.path.getmtime(os.path.join(out, name)) for name in before} == before
    assert train_cli.export_step(out) == 6


def test_warm_start_from_init_from(run, data_dir, tmp_path, monkeypatch):
    """No checkpoint: the weights of --init_from, the optimizer's counts at
    --init_step, the data and draws seeded from it; a tree of another
    config is refused."""
    monkeypatch.setenv("MBEXWN_PLATFORM", "cpu")
    out = str(tmp_path / "warm")
    result, err = _train(data_dir, out, 7, init_from=os.path.join(run["dir"], "weights.npz"), init_step=6)
    assert f"warm-started from {run['dir']}" in err and result["warm_started"] and result["start_step"] == 6
    recs = [json.loads(line) for line in open(os.path.join(out, "logs", "metrics.jsonl"))]
    assert [r["step"] for r in recs] == [7]
    state = torch.load(CheckpointManager(os.path.join(out, "checkpoints")).path(7), weights_only=True)
    assert state["scheduler"]["last_epoch"] == 7 and all(float(s["step"]) == 7 for s in state["optimizer"]["state"].values())
    registry = os.path.join(os.path.dirname(get_config_file("SPEECH")), "weights.npz")
    with pytest.raises(RuntimeError, match="structure does not match"):
        _train(data_dir, str(tmp_path / "bad"), 7, init_from=registry)


def test_pretraining_runs_before_the_first_step(data_dir, tmp_path, monkeypatch):
    monkeypatch.setenv("MBEXWN_PLATFORM", "cpu")
    cargs = CARGS + ["training_config:pretrain_activations_target=1.0",
                     "training_config:pretrain_activations_max_iters=2"]
    result, err = _train(data_dir, str(tmp_path / "pre"), 1, cargs=cargs)
    assert result["pretrained"] and "pretraining done (stats loss" in err


def test_export_loads_in_both_mel_inverters(run):
    """fp32 synthesis of the exported model in the JAX package and in the
    port (CPU), given the JAX package's noise draw: within 1e-3 rel-RMS."""
    mel = (np.random.RandomState(0).randn(1, 8, 80) * 0.5 - 4).astype(np.float32)
    y_jax = JaxMELInverter(run["dir"], length_buckets=(8,)).synth_from_mel(mel)
    inv = MELInverter(run["dir"], device="cpu", length_buckets=(8,))
    noise = np.asarray(jax.random.normal(jax.random.PRNGKey(0), inv.noise_shape(mel), jnp.float32))
    y = inv.synth_from_mel(mel, noise=noise)
    assert y.shape == y_jax.shape == (8 * 300,) and np.isfinite(y).all()
    assert rel_rms(y, y_jax) <= 1e-3, rel_rms(y, y_jax)


def test_n_devices_must_divide_the_batch(data_dir, tmp_path, monkeypatch):
    """The JAX CLI's check and message, before any process starts; on the
    CPU, 0 (every visible card) is not a count."""
    monkeypatch.setenv("MBEXWN_PLATFORM", "cpu")
    with pytest.raises(RuntimeError, match="batch_size 3 must be divisible by n_devices 2"):
        train_cli.main("SPEECH", data_dir, str(tmp_path), steps=1, batch_size=3, n_devices=2, cargs=CARGS)
    with pytest.raises(ValueError, match="counts the visible cards"):
        train_cli.main("SPEECH", data_dir, str(tmp_path), steps=1, batch_size=2, n_devices=0, cargs=CARGS)


# ---- the config, observability and summary pieces against the JAX package's

@pytest.mark.parametrize("model_id,cargs", [("SPEECH", None), ("SING", None), ("VOICE", None), ("SPEECH", CARGS)])
def test_dump_config_text_and_read_back_match_jax(model_id, cargs, tmp_path):
    hp = cutils.read_config(get_config_file(model_id))
    if cargs:
        cutils.modify_config(hp, cargs)
    cutils.dump_config(str(tmp_path / "port" / "config.yaml"), hp)
    jax_cutils.dump_config(str(tmp_path / "jax" / "config.yaml"), copy.deepcopy(hp))
    text = (tmp_path / "port" / "config.yaml").read_text()
    assert text == (tmp_path / "jax" / "config.yaml").read_text() and "ftype: np.float32" in text
    port_back = cutils.read_config(str(tmp_path / "port" / "config.yaml"))
    jax_back = jax_cutils.read_config(str(tmp_path / "port" / "config.yaml"))
    assert port_back == jax_back == hp


_BLOCKS = {"config_dict": lambda hp: hp, "preprocess_config": lambda hp: hp["preprocess_config"],
           "training_config": lambda hp: hp["training_config"],
           "spect_loss_config": lambda hp: hp["training_config"]["spect_loss_config"],
           "checkpoint_config": lambda hp: hp["checkpoint_config"],
           "wavenet_config": lambda hp: {"n_layers": 2, "n_channels": 8, "kernel_size": 3}}


_EDITS = [(block, edit) for block in _BLOCKS for edit in ("none", "unknown key", "missing key", "obsolete key")
          if edit != "obsolete key" or cutils._SCHEMAS[block]["obsolete"]]


@pytest.mark.parametrize("block,edit", _EDITS)
def test_validators_raise_on_the_jax_inputs(block, edit, capsys):
    hp = cutils.read_config(get_config_file("SPEECH"))
    node = copy.deepcopy(_BLOCKS[block](hp))
    schema = cutils._SCHEMAS[block]
    if edit == "unknown key":
        node["no_such_key"] = 1
    elif edit == "missing key":
        node.pop(schema["required"][0])
    elif edit == "obsolete key":
        node[schema["obsolete"][0]] = 1
    results = []
    for module in (cutils, jax_cutils):
        try:
            getattr(module, f"check_{block}")(node)
            results.append(("ok", capsys.readouterr().err))
        except RuntimeError as e:
            results.append(("raised", str(e)))
    assert results[0] == results[1]
    assert results[0][0] == ("ok" if edit in ("none", "obsolete key") else "raised")
    assert cutils._SCHEMAS == jax_cutils._SCHEMAS


def test_metrics_logger_and_check_finite_match_jax(tmp_path):
    metrics = {"a": 1.5, "b": np.float32(2.0), "c": torch.tensor(0.25), "skip": "text"}
    port, ref = MetricsLogger(str(tmp_path / "p"), "m"), jax_obs.MetricsLogger(str(tmp_path / "j"), "m")
    for logger in (port, ref):
        logger.log(3, {k: v for k, v in metrics.items() if k != "c"})
        logger.close()
    got, want = (json.loads(open(x.path).read()) for x in (port, ref))
    assert got.keys() == want.keys() == {"step", "time", "a", "b"} and got["a"] == want["a"] and got["b"] == want["b"]
    port2 = MetricsLogger(str(tmp_path / "p"), "m")  # appends
    port2.log(4, metrics)
    port2.close()
    assert [json.loads(line)["step"] for line in open(port2.path)] == [3, 4]
    tree = {"x": np.array([1.0, np.nan, np.inf]), "y": [np.zeros(2), np.array([np.nan])]}
    messages = []
    for fn in (check_finite, jax_obs.check_finite):
        with pytest.raises(FloatingPointError) as e:
            fn(tree, "t")
        messages.append(str(e.value))
    assert messages[0] == messages[1] == "t['x']: 2 non-finite values"
    check_finite({"x": torch.ones(3), "y": [torch.zeros(2, dtype=torch.bfloat16)]})
    with pytest.raises(FloatingPointError, match=r"p\['y'\]\[1\]: 1 non-finite"):
        check_finite({"y": [torch.zeros(1), torch.tensor([float("nan")])]}, "p")


@pytest.mark.parametrize("model_id,cargs", [("SPEECH", CARGS), ("VOICE", None)])
def test_model_summary_prints_the_jax_lines(model_id, cargs):
    hp = cutils.read_config(get_config_file(model_id))
    if cargs:
        cutils.modify_config(hp, cargs)
    jmodel, _ = jax_create_model(hp, hp["training_config"], hp["preprocess_config"], quiet=True)
    params = jax.jit(lambda k: jmodel.init(k, batch_size=1, T_mel=8))(jax.random.PRNGKey(0))
    ref, got = [], []
    jax_obs.model_summary(jmodel, params, T_mel=21, print_fn=ref.append)
    model, _ = create_model(hp, hp["training_config"], hp["preprocess_config"], trainable=True)
    model_summary(model, T_mel=21, print_fn=got.append)
    assert got == ref and any("total params" in line for line in got)
