from radzero_torch.config.config import Config, load_config, str2bool, update_nested_dict

__all__ = ["Config", "load_config", "str2bool", "update_nested_dict"]
