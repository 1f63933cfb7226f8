from repro_torch.kernels.ssd_scan.ops import ssd_scan_fused

__all__ = ["ssd_scan_fused"]
