"""The port's AOT export path (compat/export.py, cli/export_model.py,
cli/export_from_checkpoint.py) and its kernel ops, on the CPU.

The model is the JAX export test's (tests/test_export.py): SPEECH with a
16-channel, 2-layer WaveNet, no mel RMS normalisation and the noise channel
at sigma 0, initialised by the JAX package and written as a model
directory, so both packages load the same weights.

- The port's artifact against the JAX package's artifact (`export_synthesis`
  / `load_exported` of mbexwn_vocoder_tpu) on the same weights and mel:
  within 1e-3 rel-RMS, the whole-synthesis budget; against the port's eager
  `infer`, bit-equal.
- The round trip `export_model_dir` + `synth_from_artifact`, the CLI, an
  artifact loaded in a process that cannot import the port's `models`,
  `nn`, `config` or `mel_inverter`, and the refusals: garbage and a JAX
  artifact raise ValueError, a platform the artifact lacks raises.
- The exported graph holds one `mbexwn::wavenet_stack` node per WaveNet
  block and one `mbexwn::oscillate` node; exporting leaves no traced tensor
  in the model's stack cache.
- `torch.library.opcheck` on both ops (their CPU implementation is the
  plain version).
- The training CLI with `remat_wavenet_blocks` from `-a`: each step sends
  both WaveNet blocks through `torch.utils.checkpoint`;
  `cli.export_from_checkpoint` on that run's checkpoint writes the run's
  own export.
"""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

import mbexwn_vocoder_tpu as jax_mv
from mbexwn_vocoder_tpu.compat import export as jax_export
from mbexwn_vocoder_tpu.compat.params_io import save_params as jax_save_params
from mbexwn_vocoder_tpu.config import dump_config as jax_dump_config
from mbexwn_vocoder_tpu.config import read_config as jax_read_config
from mbexwn_vocoder_tpu.models import create_model as jax_create_model

from mbexwn_vocoder_torch.compat.export import export_model_dir, export_synthesis, load_exported, synth_from_artifact
from mbexwn_vocoder_torch.compat.params_io import flatten, load_params
from mbexwn_vocoder_torch.mel_inverter import MELInverter
from mbexwn_vocoder_torch.ops.oscillator import oscillate_plain
from mbexwn_vocoder_torch.ops.wavenet_stack import pack_stack_weights
from mbexwn_vocoder_torch.training.parity import rel_rms
from mbexwn_vocoder_torch.training.synthetic import make_corpus

from tests.test_torch_train_cli import CARGS, _train

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parent.parent
T_MEL, HOP = 8, 300


def _mel(seed):
    return (np.random.RandomState(seed).randn(1, T_MEL, 80) * 0.5 - 4).astype(np.float32)


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """The JAX export test's model directory; (dir, JAX model, JAX params)."""
    hp = jax_read_config(jax_mv.get_config_file("SPEECH"))
    mc = hp["mbexwn_config"]
    mc["pp_mod_subnet"].update(n_channels=16, n_layers=2, n_out_channels=8)
    mc["normalize_rms_from_mell"] = False
    mc["pp_mod_subnet_noise_channel_sigma"] = 0.0
    model, _ = jax_create_model(hp, hp["training_config"], hp["preprocess_config"], quiet=True)
    params = model.init(jax.random.PRNGKey(0), batch_size=1, T_mel=T_MEL)
    d = str(tmp_path_factory.mktemp("aot"))
    jax_save_params(os.path.join(d, "weights.npz"), params)
    jax_dump_config(os.path.join(d, "config.yaml"), hp)
    return d, model, params


@pytest.fixture(scope="module")
def port_model(model_dir):
    return MELInverter(model_dir[0], device="cpu", length_buckets=(T_MEL,)).model


@pytest.fixture(scope="module")
def artifact(port_model):
    return export_synthesis(port_model, T_mel=T_MEL, batch_size=1)


def test_artifact_matches_jax_artifact_and_eager(model_dir, port_model, artifact):
    _, jmodel, params = model_dir
    call, meta = load_exported(artifact, device="cpu")
    assert meta["platforms"] == ["cpu"] and meta["T_mel"] == T_MEL and meta["hop_size"] == HOP
    assert meta["wn_dtype"] == meta["subnet_dtype"] == "float32" and meta["noise"] is None  # conftest pins fp32
    jcall, _ = jax_export.load_exported(jax_export.export_synthesis(jmodel, params, T_mel=T_MEL, batch_size=1))
    mel = _mel(0)
    y = call(mel)
    with torch.no_grad():
        eager = port_model.infer(torch.from_numpy(mel), synth_length=T_MEL * HOP)
    y_jax = np.asarray(jcall(mel))
    err = rel_rms(y.numpy(), y_jax)
    print(f"port artifact vs JAX artifact: rel-RMS {err:.2e}")
    assert y.shape == (1, T_MEL * HOP) and err <= 1e-3
    assert torch.equal(y, eager)


def test_graph_holds_one_node_per_kernel_and_no_traced_tensor_is_kept(port_model):
    from mbexwn_vocoder_torch.compat.export import _serving_copy, _Synthesis

    program = _serving_copy(port_model, torch.device("cpu"))
    with torch.no_grad():
        ep = torch.export.export(_Synthesis(program, None, T_MEL * HOP), (torch.zeros(1, T_MEL, 80),), strict=False)
    targets = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert targets.count("mbexwn.wavenet_stack.default") == len(port_model.block.block_names)
    assert targets.count("mbexwn.oscillate.default") == 1
    # the unfrozen model traced directly: its stack cache keeps no tensor made while tracing
    with torch.no_grad():
        port_model.infer(torch.from_numpy(_mel(1)), synth_length=T_MEL * HOP)
        caches = [getattr(port_model.block, n).wavenet._stack_cache for n in port_model.block.block_names]
        torch.export.export(_Synthesis(port_model, None, T_MEL * HOP), (torch.zeros(1, T_MEL, 80),), strict=False)
    after = [getattr(port_model.block, n).wavenet._stack_cache for n in port_model.block.block_names]
    assert all(a[0] == b[0] and a[1] is b[1] for a, b in zip(after, caches))
    kept = [t for c in after for t in [*c[2], c[1].w_dil, c[1].b_dil, c[1].w_rs, c[1].b_rs]]
    assert not any(isinstance(t, torch._subclasses.FakeTensor) for t in kept)


def test_export_model_dir_serves_and_the_cli_writes_the_same_program(model_dir, port_model, tmp_path,
                                                                      monkeypatch):
    monkeypatch.setenv("MBEXWN_PLATFORM", "cpu")
    out = str(tmp_path / "model.pt2aot")
    meta = export_model_dir(model_dir[0], out, T_mel=T_MEL)
    assert os.path.getsize(out) == meta["bytes"] > 10_000 and meta["platforms"] == ["cpu"]
    mel = _mel(2)
    y = synth_from_artifact(out, mel, device="cpu")
    with torch.no_grad():
        eager = port_model.infer(torch.from_numpy(mel), synth_length=T_MEL * HOP).numpy()
    assert y.shape == (1, T_MEL * HOP) and np.array_equal(y, eager)
    cli_out = str(tmp_path / "cli.pt2aot")
    res = subprocess.run([sys.executable, "-m", "mbexwn_vocoder_torch.cli.export_model", "--model", model_dir[0],
                          "-o", cli_out, "-T", str(T_MEL)], cwd=str(REPO), capture_output=True, text=True,
                         timeout=300, env={**os.environ, "MBEXWN_PLATFORM": "cpu"})
    assert res.returncode == 0, res.stderr
    assert "wrote" in res.stderr and np.array_equal(synth_from_artifact(cli_out, mel, device="cpu"), y)


def test_artifact_loads_without_the_model_code(artifact, tmp_path):
    """A process in which the port's models, nn, config and mel_inverter
    cannot be imported loads and runs the artifact."""
    path = tmp_path / "model.pt2aot"
    path.write_bytes(artifact)
    mel = _mel(3)
    np.save(tmp_path / "mel.npy", mel)
    code = ("import sys\n"
            "for name in ('models', 'nn', 'config', 'mel_inverter'):\n"
            "    sys.modules['mbexwn_vocoder_torch.' + name] = None\n"
            "import numpy as np\n"
            "from mbexwn_vocoder_torch.compat.export import synth_from_artifact\n"
            f"y = synth_from_artifact({str(path)!r}, np.load({str(tmp_path / 'mel.npy')!r}), device='cpu')\n"
            f"np.save({str(tmp_path / 'y.npy')!r}, y)\n"
            "assert not any(k.startswith('mbexwn_vocoder_torch.' + n) and sys.modules[k] is not None\n"
            "               for k in list(sys.modules) for n in ('models', 'nn', 'config', 'mel_inverter'))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    call, _ = load_exported(artifact, device="cpu")
    assert np.array_equal(np.load(tmp_path / "y.npy"), call(mel).numpy())


def test_load_refuses_what_is_not_its_artifact(model_dir, artifact):
    _, jmodel, params = model_dir
    for blob in (b"not an artifact", b"MBEXWN_TORCH_AOT1\n" + (5).to_bytes(8, "little") + b"{...}"):
        with pytest.raises(ValueError):
            load_exported(blob, device="cpu")
    with pytest.raises(ValueError, match="JAX package"):
        load_exported(jax_export.export_synthesis(jmodel, params, T_mel=T_MEL, batch_size=1), device="cpu")
    with pytest.raises(ValueError, match="not for cuda"):
        load_exported(artifact, device="cuda")
    call, _ = load_exported(artifact, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        call(np.zeros((2, T_MEL, 80), np.float32))


# ---- the kernel ops


def _stack_args(C=8, B=2, T=33, dils=(1, 4, 2)):
    g = torch.Generator().manual_seed(0)
    layers = []
    for i in range(len(dils)):
        out = C if i == len(dils) - 1 else 2 * C
        layers.append((torch.randn(2 * C, 3, C, generator=g) * 0.2, torch.randn(2 * C, generator=g) * 0.05,
                       torch.randn(out, C, generator=g) * 0.2, torch.randn(out, generator=g) * 0.05))
    p = pack_stack_weights(layers)
    return (torch.randn(B, T, C, generator=g), torch.randn(B, T, 2 * C, generator=g), p.w_dil, p.b_dil, p.w_rs,
            p.b_rs, list(dils), list(p.skip_only))


@pytest.mark.parametrize("causal", [False, True])
def test_opcheck_wavenet_stack(causal):
    args = (*_stack_args(), "gtu", causal)
    torch.library.opcheck(torch.ops.mbexwn.wavenet_stack.default, args)
    assert args[-3] == [False, False, True]  # the last layer is skip-only


@pytest.mark.parametrize("with_offset,return_phase", [(False, False), (True, True)])
def test_opcheck_oscillate(with_offset, return_phase):
    g = torch.Generator().manual_seed(1)
    f0 = 80.0 + 200.0 * torch.rand(2, 2345, generator=g)
    tables = torch.randn(65, 5, generator=g)
    offset = torch.rand(2, generator=g) if with_offset else None
    args = (f0, tables, 50.0, 1.25, 1.0, 2.4, 12000.0, offset, return_phase)
    torch.library.opcheck(torch.ops.mbexwn.oscillate.default, args)
    audio, phase = torch.ops.mbexwn.oscillate(*args)
    ref_audio, ref_phase = oscillate_plain(*args[:7], phase_offset=offset, return_phase=True)
    assert torch.equal(audio, ref_audio) and (torch.equal(phase, ref_phase) if return_phase else phase.numel() == 0)


# ---- remat from the CLI, and the export of a run's checkpoint


@pytest.fixture(scope="module")
def remat_run(tmp_path_factory):
    """2 steps of the training CLI's tiny run with
    `-a mbexwn_config:remat_wavenet_blocks=True` on the CPU; (run dir, the
    blocks that went through torch.utils.checkpoint)."""
    import mbexwn_vocoder_torch.models.mbexwn as port_mbexwn

    data = str(tmp_path_factory.mktemp("data"))
    make_corpus(data, n_utterances=2, seed=0, duration_range=(1.0, 1.5), quiet=True)
    out = str(tmp_path_factory.mktemp("remat"))
    calls = []
    mp = pytest.MonkeyPatch()
    mp.setenv("MBEXWN_PLATFORM", "cpu")
    mp.setattr(port_mbexwn, "checkpoint", lambda block, *a, **k: calls.append(block.name) or
               torch.utils.checkpoint.checkpoint(block, *a, **k))
    try:
        _train(data, out, 2, cargs=CARGS + ["mbexwn_config:remat_wavenet_blocks=True"])
    finally:
        mp.undo()
    return out, calls


def test_cli_trains_with_remat_from_cargs(remat_run):
    run, calls = remat_run
    with open(os.path.join(run, "logs", "metrics.jsonl")) as f:
        losses = [json.loads(line)["total_loss"] for line in f]
    assert len(losses) == 2 and np.isfinite(losses).all()
    assert calls == ["PP_waveNetBlock_ups2_0", "PP_waveNetBlock_ups1_1"] * 2, calls


def test_export_from_checkpoint_writes_the_runs_export(remat_run, tmp_path):
    run = str(tmp_path / "run")
    shutil.copytree(remat_run[0], run)
    own = flatten(load_params(os.path.join(run, "weights.npz")))
    for name in ("weights.npz", "config.yaml", "weights.step"):
        os.remove(os.path.join(run, name))
    res = subprocess.run([sys.executable, "-m", "mbexwn_vocoder_torch.cli.export_from_checkpoint", "--run", run,
                          "--model", "SPEECH", "--cargs", *CARGS, "mbexwn_config:remat_wavenet_blocks=True"],
                         cwd=str(REPO), capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert json.loads(res.stdout.strip().splitlines()[-1]) == {"run": run, "exported_step": 2}
    got = flatten(load_params(os.path.join(run, "weights.npz")))
    assert got.keys() == own.keys() and all(np.array_equal(got[k], own[k]) for k in own)
    with open(os.path.join(run, "weights.step")) as f:
        assert f.read().strip() == "2"
    assert MELInverter(run, device="cpu").model.block.remat_wavenet_blocks
