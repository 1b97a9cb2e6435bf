"""Architecture registry of the port (``repro.configs``'s ids and aliases;
every config but the hybrid zamba2-2.7b is served so far)."""
from repro_torch.configs.registry import (ALIASES, ARCH_IDS, describe,
                                          get_config, get_reduced)

__all__ = ["ALIASES", "ARCH_IDS", "describe", "get_config", "get_reduced"]
