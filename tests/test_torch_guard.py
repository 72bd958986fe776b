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

REPO = Path(__file__).resolve().parent.parent
PKG = REPO / "mbexwn_vocoder_torch"


def _port_modules():
    return sorted(m.name for m in pkgutil.walk_packages([str(PKG)], prefix="mbexwn_vocoder_torch."))


def test_every_module_imports_with_jax_blocked():
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['jaxlib'] = None\n"
            "sys.modules['mbexwn_vocoder_tpu'] = None\n"
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


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")) + [REPO / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_jax_package_import(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in ("jax", "jaxlib", "mbexwn_vocoder_tpu")]
    assert not bad, f"{path} imports {bad}"


def test_no_kernel_is_built_at_import():
    code = ("import mbexwn_vocoder_torch.mel_inverter, mbexwn_vocoder_torch.ops.kernel_lib as k\n"
            "assert k._lib is None and not k.build_info\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), capture_output=True, text=True, timeout=300)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_entry_points_default_to_the_card():
    assert inspect.signature(MELInverter.__init__).parameters["device"].default == "cuda"


def test_no_silent_cpu_fallback():
    """Without a GPU, asking for the card (the default) raises; it does not
    carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a GPU; the check is about hosts without one")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MELInverter("SPEECH")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        MELInverter()


def _speech_hparams():
    return read_config(get_config_file("SPEECH"))


@pytest.mark.parametrize("edit,item", [
    (lambda mc: mc.update(force_causal=True), "item 10"),
    (lambda mc: mc.update(ps_use_stft=False), "item 13"),
    (lambda mc: mc.update(pulse_channels_use_pqmf=True), "item 13"),
    (lambda mc: mc["wavetable_config"].update(use_sinusoid_as_fun=True), "item 13"),
    (lambda mc: mc["wavetable_config"].update(add_subharm_chans=2), "item 13"),
    (lambda mc: mc["pp_mod_subnet"].update(n_ch_groups=2), "item 13"),
    (lambda mc: mc.update(normalize_rms_num_smooth_iters=2), "item 13"),
    (lambda mc: mc.update(pp_subnet_training_only=True), "item 12"),
])
def test_unported_branches_raise(edit, item):
    hp = copy.deepcopy(_speech_hparams())
    edit(hp["mbexwn_config"])
    with pytest.raises(NotImplementedError, match=item):
        create_model(hp, hp["training_config"], hp["preprocess_config"])


def test_unported_wavenet_branches_raise():
    base = dict(n_channels=8, n_out_channels=4, cond_conv_upsampling=1)
    for kw, item in ((dict(padding="CAUSAL"), "item 10"), (dict(cond_conv_upsampling=None), "item 13"),
                     (dict(kernel_size=5), "item 13")):
        with pytest.raises(NotImplementedError, match=item):
            WaveNetAE(3, 5, **{**base, **kw})


def test_unknown_config_key_is_refused():
    hp = copy.deepcopy(_speech_hparams())
    hp["mbexwn_config"]["no_such_option"] = 1
    with pytest.raises(TypeError, match="no_such_option"):
        create_model(hp, hp["training_config"], hp["preprocess_config"])
