"""Model factory: only the mbexwn family exists."""
from __future__ import annotations

from .pan_wavenet import PaNWaveNet


def create_model(hparams, training_config, preprocess_config, name="myWaveGlow", quiet=True, **_):
    """Returns (model, mr_mode)."""
    if "mbexwn_config" in hparams:
        model = PaNWaveNet(model_config=hparams["mbexwn_config"], training_config=training_config,
                           preprocess_config=preprocess_config, quiet=quiet, name=name)
        return model, False
    raise NotImplementedError(f"create_model::error::unknown config requested {list(hparams.keys())}. "
                              f"Only mbexwn_config is currently supported.")
