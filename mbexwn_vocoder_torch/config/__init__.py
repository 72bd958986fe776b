from .config_utils import read_config

__all__ = ["read_config"]
