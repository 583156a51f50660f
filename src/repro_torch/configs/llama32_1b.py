"""--arch config module (see archs.py for the definition)."""
from repro_torch.configs.archs import LLAMA32_1B as CONFIG

__all__ = ["CONFIG"]
