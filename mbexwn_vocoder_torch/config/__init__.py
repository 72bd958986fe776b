from .config_utils import (
    check_checkpoint_config,
    check_config_dict,
    check_preprocess_config,
    check_spect_loss_config,
    check_training_config,
    check_wavenet_config,
    dump_config,
    get_list_parameter,
    get_model_config,
    modify_config,
    read_config,
)

__all__ = ["check_checkpoint_config", "check_config_dict", "check_preprocess_config", "check_spect_loss_config",
           "check_training_config", "check_wavenet_config", "dump_config", "get_list_parameter", "get_model_config",
           "modify_config", "read_config"]
