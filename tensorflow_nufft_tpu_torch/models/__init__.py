"""Application model families built on the NUFFT (MRI reconstruction)."""

from tensorflow_nufft_tpu_torch.models import mri

__all__ = ["mri"]
