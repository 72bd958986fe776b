from .factory import create_model, create_registry_model
from .mbexwn import MBExWN
from .pan_wavenet import NormMelComponents, PaNWaveNet
from .waveglow import WaveGlow

__all__ = ["create_model", "create_registry_model", "MBExWN", "NormMelComponents", "PaNWaveNet", "WaveGlow"]
