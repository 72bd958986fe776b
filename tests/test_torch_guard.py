"""Boundaries of the PyTorch port: it imports neither JAX nor the JAX
package, it runs on the card unless the caller asks for the CPU, it builds
no kernel at import, and config branches it does not port raise."""
import ast
import copy
import inspect
import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from mbexwn_vocoder_torch import get_config_file
from mbexwn_vocoder_torch.config import read_config
from mbexwn_vocoder_torch.mel_inverter import MELInverter
from mbexwn_vocoder_torch.models import create_model
from mbexwn_vocoder_torch.nn.wavenet import WaveNetAE
from mbexwn_vocoder_torch.parallel.batch import BatchSynthesizer
from mbexwn_vocoder_torch.parallel.streaming import StreamingSynthesizer
from mbexwn_vocoder_torch.serving import PipelinedSynthesizer
from mbexwn_vocoder_torch.training.adversarial import AdversarialTrainer
from mbexwn_vocoder_torch.training.trainer import Trainer

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "mbexwn_vocoder_torch"
PORT_TOOLS = sorted((REPO / "tools").glob("torch_*.py")) + [REPO / "tools" / "quality_eval_torch.py"]
_BLOCK_JAX = ("import sys\n"
              "sys.modules['jax'] = None\n"
              "sys.modules['jaxlib'] = None\n"
              "sys.modules['mbexwn_vocoder_tpu'] = None\n")


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PKG)], prefix="mbexwn_vocoder_torch."))


def test_every_module_imports_with_jax_blocked():
    code = (_BLOCK_JAX +
            "import importlib\n"
            f"for name in {_port_modules()!r}:\n"
            "    importlib.import_module(name)\n"
            "assert not any(k == 'jax' or k.startswith('jax.') for k in sys.modules if sys.modules[k] is not None)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"] + PORT_TOOLS,
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_jax_package_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in ("jax", "jaxlib", "mbexwn_vocoder_tpu")]
    assert not bad, f"{path} imports {bad}"


def test_no_optax_in_the_port():
    """The port's optimizer is torch.optim: no file of the package names the
    JAX package's optimizer library."""
    assert not [p for p in PKG.rglob("*.py") if "optax" in p.read_text()]


def test_no_orbax_in_the_port():
    """The port's checkpoints are torch.save files: no file of the package
    names the JAX package's checkpoint library."""
    assert not [p for p in PKG.rglob("*.py") if "orbax" in p.read_text().lower()]


def test_train_cli_runs_with_jax_blocked(tmp_path):
    """`python -m mbexwn_vocoder_torch.cli.train` trains a step of a tiny
    config on the CPU (MBEXWN_PLATFORM=cpu) and exports, importing nothing
    of JAX."""
    import os

    from mbexwn_vocoder_torch.training.synthetic import make_corpus

    make_corpus(str(tmp_path / "data"), n_utterances=1, seed=0, duration_range=(1.0, 1.2), quiet=True)
    argv = ["train", "SPEECH", "-d", str(tmp_path / "data"), "-o", str(tmp_path / "run"), "--steps", "1", "-b", "1",
            "--num_workers", "1", "-a", "mbexwn_config:pp_mod_subnet:n_channels=8",
            "mbexwn_config:pp_mod_subnet:n_layers=2", "mbexwn_config:pp_mod_subnet:n_out_channels=8",
            "preprocess_config:segment_length=3000"]
    code = (_BLOCK_JAX +
            "import runpy\n"
            f"sys.argv = {argv!r}\n"
            "runpy.run_module('mbexwn_vocoder_torch.cli.train', run_name='__main__')\n"
            "assert not any(k == 'jax' or k.startswith('jax.') for k in sys.modules if sys.modules[k] is not None)\n"
            "print('ok')\n")
    env = dict(os.environ, MBEXWN_PLATFORM="cpu")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr
    assert "exported inference model to" in out.stderr
    assert sorted(os.listdir(tmp_path / "run")) == ["checkpoints", "config.yaml", "logs", "weights.npz", "weights.step"]


def test_no_kernel_is_built_at_import():
    code = ("import mbexwn_vocoder_torch.mel_inverter, mbexwn_vocoder_torch.ops.kernel_lib as k\n"
            "assert k._lib is None and not k.build_info\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_cli_entry_points_run_with_jax_blocked():
    """`python -m` of each CLI (resynth_mel lists the models; the others
    print their help) and the quality tool (as far as its model, which
    needs the card unless MBEXWN_PLATFORM=cpu) import nothing of JAX."""
    code = (_BLOCK_JAX +
            "import runpy\n"
            "for mod, argv in (('resynth_mel', []), ('generate_mel', ['-h']), ('view_mel', ['-h'])):\n"
            "    sys.argv = [mod] + argv\n"
            "    try:\n"
            "        runpy.run_module('mbexwn_vocoder_torch.cli.' + mod, run_name='__main__')\n"
            "    except SystemExit as e:\n"
            "        assert e.code == 0, (mod, e.code)\n"
            "sys.argv = ['quality_eval_torch.py', '--model', 'SPEECH']\n"
            "try:\n"
            "    runpy.run_path('tools/quality_eval_torch.py', run_name='__main__')\n"
            "except (RuntimeError, SystemExit) as e:\n"
            "    print(type(e).__name__, e)\n"
            "assert not any(k == 'jax' or k.startswith('jax.') for k in sys.modules if sys.modules[k] is not None)\n"
            "print('ok')\n")
    env = {k: v for k, v in __import__("os").environ.items() if k != "MBEXWN_PLATFORM"}
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode == 0 and out.stdout.strip().endswith("ok"), out.stderr
    assert "MBExWN_TPU_VOICE_WNCHA340_24kHz" in out.stdout
    if not torch.cuda.is_available():
        assert "RuntimeError no CUDA device" in out.stdout


@pytest.mark.parametrize("entry", [MELInverter.__init__, PipelinedSynthesizer.__init__, BatchSynthesizer.__init__,
                                   StreamingSynthesizer.__init__, Trainer.__init__, AdversarialTrainer.__init__])
def test_entry_points_default_to_the_card(entry):
    assert inspect.signature(entry).parameters["device"].default == "cuda"


def test_train_cli_defaults_to_the_card(tmp_path, monkeypatch):
    """The CLI has one device setting, MBEXWN_PLATFORM: unset, it asks for
    the card."""
    import mbexwn_vocoder_torch.cli.train as train_cli
    import mbexwn_vocoder_torch.platform as platform

    asked = []

    def refuse(device):
        asked.append(str(device))
        raise RuntimeError("device resolved")

    assert "device" not in inspect.signature(train_cli.main).parameters
    monkeypatch.delenv(platform.PLATFORM_ENV, raising=False)
    monkeypatch.setattr(platform, "resolve_device", refuse)
    with pytest.raises(RuntimeError, match="device resolved"):
        train_cli.main("SPEECH", str(tmp_path / "data"), str(tmp_path / "run"), steps=1)
    assert asked == ["cuda"]


def test_no_silent_cpu_fallback():
    """Without a GPU, asking for the card (the default) raises; it does not
    carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the check is about hosts without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MELInverter("SPEECH")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MELInverter()
    model = torch.nn.Linear(1, 1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PipelinedSynthesizer(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BatchSynthesizer(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamingSynthesizer(model)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(model, {})
    with pytest.raises(RuntimeError, match="no CUDA device"):
        AdversarialTrainer(model, {})


def test_synthesis_over_a_mesh_takes_the_mesh_devices():
    """A mesh replaces `device`: the synthesizers run on its first device
    and hold one replica per distinct device; a mesh asks for every card
    unless it is given devices; a model axis makes a 2-D grid, which batch
    synthesis and streaming both take (streaming refused it until the
    repair that ported 13d's rest; tests/test_torch_tensor_parallel.py
    holds its output)."""
    from mbexwn_vocoder_torch.parallel.mesh import make_mesh

    hp = _speech_hparams()
    hp["mbexwn_config"]["pp_mod_subnet"].update(n_channels=8, n_layers=2, n_out_channels=8)
    model, _ = create_model(hp, hp["training_config"], hp["preprocess_config"])
    mesh = make_mesh(devices=["cpu", "cpu"])
    for synth in (StreamingSynthesizer(model, mesh=mesh), BatchSynthesizer(model, mesh=mesh)):
        assert synth.device == torch.device("cpu") and list(synth.replicas) == [torch.device("cpu")]
    grid = make_mesh(n_model=2, devices=["cpu", "cpu"])
    assert grid.shape == {"data": 1, "model": 2} and grid.grid == ((torch.device("cpu"),) * 2,)
    assert BatchSynthesizer(model, mesh=grid).device == torch.device("cpu")
    ss = StreamingSynthesizer(model, mesh=grid)
    assert ss.device == torch.device("cpu") and list(ss.replicas) == [torch.device("cpu")]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh()


def test_training_is_data_parallel_over_a_process_group(monkeypatch):
    """The trainers take a process group (one process per card), not a
    mesh; joining one defaults to the card and NCCL, and NCCL without a
    card raises (no switch to gloo, no fallback to the CPU)."""
    from mbexwn_vocoder_torch.parallel import multihost

    for entry in (Trainer.__init__, AdversarialTrainer.__init__):
        params = inspect.signature(entry).parameters
        assert "mesh" not in params and params["group"].default is None
    if torch.cuda.is_available():
        pytest.skip("this host has a card; the refusal is about hosts without one")
    monkeypatch.delenv("MBEXWN_PLATFORM", raising=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        multihost.initialize("127.0.0.1:1", world_size=1, rank=0)
    with pytest.raises(RuntimeError, match="nccl backend needs a card"):
        multihost.initialize("127.0.0.1:1", world_size=1, rank=0, backend="nccl", device="cpu")


def _speech_hparams():
    return read_config(get_config_file("SPEECH"))


_PULSE_PQMF = {"subbands": 6, "taps": 94, "cutoff_ratio": 0.0945, "beta": 9.0}


@pytest.mark.parametrize("edit,item", [
    (lambda mc: mc.update(ps_use_stft=False), "item 13"),
    (lambda mc: mc.update(pulse_channels_use_pqmf=True, pulse_channels_multi_band_config=dict(_PULSE_PQMF)), "item 13"),
    (lambda mc: mc["wavetable_config"].update(use_sinusoid_as_fun=True), "item 13"),
    (lambda mc: mc["wavetable_config"].update(add_subharm_chans=2), "item 13"),
    (lambda mc: mc.update(normalize_rms_num_smooth_iters=2), "item 13"),
])
def test_unported_branches_raise(edit, item):
    """The branches that raised until ROADMAP item 13(e) ported them now
    build with the JAX package's parameter tree (keys and shapes of JAX's
    init, which the port's init fills) and synthesise finite audio of the
    requested length on the CPU (tests/test_torch_model_branches.py holds
    them against JAX)."""
    import jax

    from mbexwn_vocoder_tpu.models import create_model as jax_create_model
    from mbexwn_vocoder_torch.compat.params_io import flatten, params_to_jax

    hp = copy.deepcopy(_speech_hparams())
    hp["mbexwn_config"]["pp_mod_subnet"].update(n_channels=8, n_layers=2, n_out_channels=8)
    edit(hp["mbexwn_config"])
    model, _ = create_model(hp, hp["training_config"], hp["preprocess_config"], trainable=True)
    model.init(torch.Generator().manual_seed(0))
    jmodel, _ = jax_create_model(hp, hp["training_config"], hp["preprocess_config"], quiet=True)
    ref = flatten(jax.jit(lambda k: jmodel.init(k, batch_size=1, T_mel=8))(jax.random.PRNGKey(0)))
    got = params_to_jax(model.block.state_dict())
    assert got.keys() == ref.keys(), (item, sorted(got.keys() ^ ref.keys()))
    assert all(got[k].shape == ref[k].shape for k in ref), item
    with torch.no_grad():
        y = model.infer(torch.randn(1, 8, 80, generator=torch.Generator().manual_seed(1)) * 0.5 - 4,
                        synth_length=8 * 300)
    assert y.shape == (1, 8 * 300) and bool(y.isfinite().all()), item


def test_pp_subnet_training_only_builds_the_f0_subnet_alone():
    """pp_subnet_training_only (the F0 subnet's pretraining model): the port
    builds and initialises the F0 subnet only, with the JAX package's
    parameter tree (keys and shapes)."""
    import jax

    from mbexwn_vocoder_tpu.models import create_model as jax_create_model
    from mbexwn_vocoder_torch.compat.params_io import flatten, params_to_jax

    hp = copy.deepcopy(_speech_hparams())
    hp["mbexwn_config"]["pp_subnet_training_only"] = True
    model, _ = create_model(hp, hp["training_config"], hp["preprocess_config"], trainable=True)
    model.init(torch.Generator().manual_seed(0))
    jmodel, _ = jax_create_model(hp, hp["training_config"], hp["preprocess_config"], quiet=True)
    ref = flatten(jax.jit(lambda k: jmodel.init(k, batch_size=1, T_mel=8))(jax.random.PRNGKey(0)))
    got = params_to_jax(model.block.state_dict())
    assert got.keys() == ref.keys() and all(k.startswith("pp_subnet/") for k in got)
    assert all(got[k].shape == ref[k].shape for k in ref)
    assert not hasattr(model.block, "ps_subnet")


def test_unported_wavenet_branches_raise():
    """Per-layer conditioning and kernel size 5 were refused before they
    were ported; they now build and synthesise (per-layer conditioning on
    K1's route, kernel size 5 on the layer loop), and so does a model with
    channel groups (tests/test_torch_wavenet_branches.py holds them against
    JAX).  An even kernel size is refused, as in JAX."""
    base = dict(n_channels=8, n_out_channels=4, cond_conv_upsampling=2, cond_lin_upsampling=2)
    for kw, T_mel, route in ((dict(cond_conv_upsampling=None), 16, "k1"), (dict(kernel_size=5), 4, "layers")):
        net = WaveNetAE(3, 5, **{**base, **kw})
        with torch.no_grad():
            y = net(torch.randn(1, 16, 3), torch.randn(1, T_mel, 5))
        assert net.route() == route and y.shape == (1, 16, 4) and bool(y.isfinite().all())
    with pytest.raises(ValueError, match="odd"):
        WaveNetAE(3, 5, **{**base, "kernel_size": 4})
    hp = copy.deepcopy(_speech_hparams())
    hp["mbexwn_config"]["pp_mod_subnet"].update(n_ch_groups=2)
    model, _ = create_model(hp, hp["training_config"], hp["preprocess_config"])
    assert all(getattr(model.block, n).wavenet.n_ch_groups == 2 for n in model.block.block_names)


def test_unknown_config_key_is_refused():
    hp = copy.deepcopy(_speech_hparams())
    hp["mbexwn_config"]["no_such_option"] = 1
    with pytest.raises(TypeError, match="no_such_option"):
        create_model(hp, hp["training_config"], hp["preprocess_config"])
