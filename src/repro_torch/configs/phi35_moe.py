"""--arch config module (see archs.py for the definition)."""
from repro_torch.configs.archs import PHI35_MOE as CONFIG

__all__ = ["CONFIG"]
