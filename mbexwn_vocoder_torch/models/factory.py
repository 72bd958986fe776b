"""Model factory: the mbexwn family (`mbexwn_config`) and WaveGlow
(`waveglow_config`, models/waveglow.py), built in the folded (inference)
form unless asked for the trainable one; `load_model` loads either with
its weights."""
from __future__ import annotations

import os

from .. import get_config_file
from ..compat.params_io import flatten, load_params
from ..config import read_config
from ..ops.conv import fold_weight_norm
from .pan_wavenet import PaNWaveNet
from .waveglow import WaveGlow


def create_model(hparams, training_config, preprocess_config, name="myWaveGlow", quiet=True, trainable=False, **_):
    """Returns (model, mr_mode); `trainable` builds the trainable form (v, g)."""
    if "mbexwn_config" in hparams:
        model = PaNWaveNet(model_config=hparams["mbexwn_config"], training_config=training_config,
                           preprocess_config=preprocess_config, quiet=quiet, name=name)
        if trainable:
            model.trainable_()
        return model, False
    if "waveglow_config" in hparams:
        if trainable:
            raise NotImplementedError("create_model: WaveGlow is ported for synthesis only (no trainable form)")
        return WaveGlow(hparams["waveglow_config"], preprocess_config), False
    raise NotImplementedError(f"create_model::error::unknown config requested {list(hparams.keys())}. "
                              f"Only mbexwn_config and waveglow_config are supported.")


def load_model(model_id_or_path: str, trainable: bool = False, quiet: bool = True, **mbexwn_overrides):
    """The one loader of a registry id or model directory (config.yaml +
    weights.npz) of either family -> (model on the CPU in eval mode, the
    hparams read, `mbexwn_overrides` applied).  The model loads the weights
    itself (`load_jax_params`), folded, or as their (v, g) in the trainable
    form with `trainable`."""
    config_file = get_config_file(model_id_or_path)
    weights_npz = os.path.join(os.path.dirname(config_file), "weights.npz")
    if not os.path.exists(weights_npz):
        raise FileNotFoundError(f"no weights.npz in {os.path.dirname(config_file)}")
    hparams = read_config(config_file)
    if mbexwn_overrides:
        hparams["mbexwn_config"].update(mbexwn_overrides)
    model, _ = create_model(hparams, hparams["training_config"], hparams["preprocess_config"], quiet=quiet,
                            trainable=trainable)
    params = load_params(weights_npz)
    model.load_jax_params(flatten(params if trainable else fold_weight_norm(params)))
    return model.eval(), hparams


def create_registry_model(model_id_or_path: str, trainable: bool = False, **mbexwn_overrides) -> PaNWaveNet:
    """`load_model`'s model of a registry id or directory, keys of its
    `mbexwn_config` overridden (e.g. force_causal=True,
    pp_mod_subnet_noise_channel_sigma=0, normalize_rms_from_mell=False).
    Causal padding changes no parameter; sigma 0 is the shipped model with
    its noise at zero (`PaNWaveNet.load_jax_params`)."""
    return load_model(model_id_or_path, trainable=trainable, **mbexwn_overrides)[0]
