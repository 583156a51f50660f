"""--arch config module (see archs.py for the definition)."""
from repro_torch.configs.archs import GEMMA2_27B as CONFIG

__all__ = ["CONFIG"]
