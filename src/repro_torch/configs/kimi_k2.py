"""--arch config module (see archs.py for the definition)."""
from repro_torch.configs.archs import KIMI_K2 as CONFIG

__all__ = ["CONFIG"]
