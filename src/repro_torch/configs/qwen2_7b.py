"""--arch config module (see archs.py for the definition)."""
from repro_torch.configs.archs import QWEN2_7B as CONFIG

__all__ = ["CONFIG"]
