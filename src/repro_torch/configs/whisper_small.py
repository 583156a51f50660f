"""--arch config module (see archs.py for the definition)."""
from repro_torch.configs.archs import WHISPER_SMALL as CONFIG

__all__ = ["CONFIG"]
