from repro_torch.kernels.patch_bitmap.ops import patch_bitmap
from repro_torch.kernels.patch_bitmap.ref import patch_bitmap_ref

__all__ = ["patch_bitmap", "patch_bitmap_ref"]
