"""Architecture registry of the port (``repro.configs``'s ids and aliases;
every config is served)."""
from repro_torch.configs.registry import (ALIASES, ARCH_IDS, describe,
                                          get_config, get_reduced)

__all__ = ["ALIASES", "ARCH_IDS", "describe", "get_config", "get_reduced"]
