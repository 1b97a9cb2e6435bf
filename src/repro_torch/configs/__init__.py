"""Architecture registry of the port (``repro.configs``'s ids and aliases;
the dense GQA/MHA and MLA configs and the MoE configs are served so far)."""
from repro_torch.configs.registry import (ALIASES, ARCH_IDS, describe,
                                          get_config, get_reduced)

__all__ = ["ALIASES", "ARCH_IDS", "describe", "get_config", "get_reduced"]
