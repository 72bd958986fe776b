from .factory import create_model
from .mbexwn import MBExWN
from .pan_wavenet import NormMelComponents, PaNWaveNet

__all__ = ["create_model", "MBExWN", "NormMelComponents", "PaNWaveNet"]
