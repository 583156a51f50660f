from repro_torch.runtime import checkpoint, train
from repro_torch.runtime.pipeline import make_layer_executor

__all__ = ["checkpoint", "make_layer_executor", "train"]
