from repro_torch.runtime.pipeline import make_layer_executor

__all__ = ["make_layer_executor"]
