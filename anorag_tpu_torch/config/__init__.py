from anorag_tpu_torch.config.defaults import DEFAULT_CONFIG, default_config
from anorag_tpu_torch.config.loader import (Config, ConfigLoader, as_config, config,
                                            deep_merge, get_path, set_path)

# the port's old name for the defaults tree
DEFAULTS = DEFAULT_CONFIG

__all__ = [
    "DEFAULT_CONFIG",
    "default_config",
    "ConfigLoader",
    "config",
    "deep_merge",
    "get_path",
    "set_path",
    "Config",
    "as_config",
    "DEFAULTS",
]
