"""Model factory: the mbexwn family (`mbexwn_config`) and WaveGlow
(`waveglow_config`, models/waveglow.py).  `create_registry_model`
builds a registry model with config keys overridden and its shipped
weights.  Either builds the folded (inference) form unless asked for the
trainable one."""
from __future__ import annotations

import os

from .. import get_config_file
from ..compat.params_io import flatten, load_params, params_from_jax
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


def create_registry_model(model_id_or_path: str, trainable: bool = False, **mbexwn_overrides) -> PaNWaveNet:
    """A registry model (id or directory) with keys of its `mbexwn_config`
    overridden (e.g. force_causal=True, pp_mod_subnet_noise_channel_sigma=0,
    normalize_rms_from_mell=False) and its shipped weights, on the CPU in
    eval mode.  Causal padding changes no parameter.  With the noise channel
    overridden off (sigma 0) block 0's folded start kernel loses its last
    input column, the noise's: the shipped model with its noise at zero.
    `trainable` loads the checkpoint's (v, g) as they are, in the trainable
    form: the start of a fine-tuning run (the column drop has no (v, g)
    counterpart, so sigma 0 then fails to load)."""
    config_file = get_config_file(model_id_or_path)
    hparams = read_config(config_file)
    hparams["mbexwn_config"].update(mbexwn_overrides)
    model, _ = create_model(hparams, hparams["training_config"], hparams["preprocess_config"], trainable=trainable)
    params = load_params(os.path.join(os.path.dirname(config_file), "weights.npz"))
    flat = flatten(params if trainable else fold_weight_norm(params))
    blk = model.block
    start = f"{blk.block_names[0]}/wavenet/start/kernel"
    noise_off = "pp_mod_subnet_noise_channel_sigma" in mbexwn_overrides and not blk.pp_mod_subnet_noise_channel_sigma
    if noise_off and not trainable and flat[start].shape[1] == blk.wn_in_channels + 1:
        flat[start] = flat[start][:, :-1]
    blk.load_state_dict(params_from_jax(flat), strict=True)
    return model.eval()
