"""--arch config module (see archs.py for the definition)."""
from repro_torch.configs.archs import XLSTM_125M as CONFIG

__all__ = ["CONFIG"]
