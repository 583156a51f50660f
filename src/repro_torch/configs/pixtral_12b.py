"""--arch config module (see archs.py for the definition)."""
from repro_torch.configs.archs import PIXTRAL_12B as CONFIG

__all__ = ["CONFIG"]
