from repro_torch.kernels.ssm_scan.ops import ssd_chunked

__all__ = ["ssd_chunked"]
