"""--arch config module (see archs.py for the definition)."""
from repro_torch.configs.archs import GEMMA_2B as CONFIG

__all__ = ["CONFIG"]
