from .config_utils import modify_config, read_config

__all__ = ["modify_config", "read_config"]
