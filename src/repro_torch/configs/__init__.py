"""Architecture registry of the port (``repro.configs``'s ids and aliases;
only llama3-8b is served so far)."""
from repro_torch.configs.registry import (ALIASES, ARCH_IDS, describe,
                                          get_config, get_reduced)

__all__ = ["ALIASES", "ARCH_IDS", "describe", "get_config", "get_reduced"]
