"""The port's weight loading against the JAX package's, for all three
registry models: the npz reader, the weight-norm fold and the map onto the
port's modules (WIO kernels -> OIW)."""
import numpy as np
import pytest
import torch

from mbexwn_vocoder_tpu import get_config_file as jax_config_file
from mbexwn_vocoder_tpu.compat.params_io import load_params as jax_load_params
from mbexwn_vocoder_tpu.ops.conv import fold_weight_norm as jax_fold

from mbexwn_vocoder_torch import get_config_file, list_models
from mbexwn_vocoder_torch.compat.params_io import flatten, load_params, params_from_jax
from mbexwn_vocoder_torch.config import read_config
from mbexwn_vocoder_torch.mel_inverter import MELInverter
from mbexwn_vocoder_torch.models import create_model, create_registry_model
from mbexwn_vocoder_torch.ops.conv import fold_weight_norm

torch.set_num_threads(2)
MODELS = ["SPEECH", "SING", "VOICE"]


def _weights_path(model_id):
    return get_config_file(model_id).replace("config.yaml", "weights.npz")


def _port_model(model_id):
    hp = read_config(get_config_file(model_id))
    model, _ = create_model(hp, hp["training_config"], hp["preprocess_config"])
    return model


def test_registry_resolves_to_the_shipped_files():
    assert list_models() == {"SING": ["MBExWN_TPU_SING_WNCHA320_24kHz"],
                             "SPEECH": ["MBExWN_TPU_SPEECH_WNCHA320_24kHz"],
                             "VOICE": ["MBExWN_TPU_VOICE_WNCHA340_24kHz"]}
    for model_id in MODELS:
        assert get_config_file(model_id) == str(jax_config_file(model_id))


@pytest.mark.parametrize("model_id", MODELS)
def test_params_from_jax_maps_every_tensor_exactly(model_id):
    """Every tensor of params_from_jax(JAX-folded tree) equals the JAX tensor
    exactly after the WIO -> OIW transpose, and the map covers the port's
    MBExWN state_dict key for key (strict load)."""
    flat = flatten(jax_fold(jax_load_params(_weights_path(model_id))))
    state = params_from_jax(flat)
    assert len(state) == len(flat)
    for path, ref in flat.items():
        *mod, leaf = path.split("/")
        ref = np.asarray(ref)
        if leaf == "kernel":
            key, expect = ".".join(mod + ["weight"]), ref.transpose(2, 1, 0)
        else:
            key, expect = ".".join(mod + ["bias" if leaf == "b" else leaf]), ref
        got = state[key].numpy()
        assert got.dtype == np.float32 and got.shape == expect.shape, key
        np.testing.assert_array_equal(got, expect, err_msg=key)
    model = _port_model(model_id)
    model.block.load_state_dict(state, strict=True)


@pytest.mark.parametrize("model_id", MODELS)
def test_port_fold_matches_jax_fold(model_id):
    """The port's own reader + fold against the JAX package's.  The norm is a
    float32 sum over (width, in) taken in another order by torch and XLA, so
    the kernels agree to a few ulp (rtol 1e-6), not bit for bit; biases,
    PReLU alphas and the wavetables are copied and agree exactly."""
    port = flatten(fold_weight_norm(load_params(_weights_path(model_id))))
    ref = flatten(jax_fold(jax_load_params(_weights_path(model_id))))
    assert sorted(port) == sorted(ref)
    for key in ref:
        r = np.asarray(ref[key])
        assert port[key].dtype == np.float32, key
        if key.endswith("kernel"):
            np.testing.assert_allclose(port[key], r, rtol=1e-6, atol=1e-9, err_msg=key)
        else:
            np.testing.assert_array_equal(port[key], r, err_msg=key)


def test_inverter_and_registry_model_hold_the_same_weights():
    """MELInverter's model and create_registry_model's, both from the one
    loader (models.factory.load_model), hold bit-equal state dicts."""
    got = MELInverter("SPEECH", device="cpu").model.state_dict()
    ref = create_registry_model("SPEECH").state_dict()
    assert got.keys() == ref.keys()
    for name, value in ref.items():
        assert got[name].dtype == value.dtype and torch.equal(got[name], value), name


def test_distribution_copy_is_upcast(tmp_path):
    """The fp16 sidecar means upcast to fp32; a tree saved without it keeps
    its dtypes."""
    path = tmp_path / "w.npz"
    np.savez(path, **{"a/v": np.ones((1, 2, 3), np.float16), "a/g": np.ones(3, np.float16),
                      "__distribution_dtype__": np.asarray("float16")})
    tree = load_params(str(path))
    assert tree["a"]["v"].dtype == np.float32 and tree["a"]["g"].dtype == np.float32
    np.savez(path, **{"a/kernel": np.ones((1, 2, 3), np.float16)})
    assert load_params(str(path))["a"]["kernel"].dtype == np.float16


def test_fold_weight_norm_formula():
    """g * v / ||v|| over (width, in) per output channel, eps 1e-12, and the
    equalized-LR variant g * v / rms(v)."""
    rng = np.random.RandomState(0)
    v = rng.randn(3, 4, 5).astype(np.float32)
    g = rng.rand(5).astype(np.float32)
    folded = fold_weight_norm({"l": {"v": v, "g": g, "b": np.zeros(5, np.float32)}})["l"]
    norm = np.sqrt(np.sum(v.astype(np.float64) ** 2, axis=(0, 1)))
    np.testing.assert_allclose(folded["kernel"], g * v / norm, rtol=1e-6)
    assert set(folded) == {"kernel", "b"}
    eq = fold_weight_norm({"v": v, "g": g, "_equalized_lr": True})
    rms = np.sqrt(np.mean(v.astype(np.float64) ** 2, axis=(0, 1)))
    np.testing.assert_allclose(eq["kernel"], g * v / rms, rtol=1e-6)
    zero = fold_weight_norm({"v": np.zeros((1, 2, 2), np.float32), "g": np.ones(2, np.float32)})
    assert np.all(np.isfinite(zero["kernel"]))
