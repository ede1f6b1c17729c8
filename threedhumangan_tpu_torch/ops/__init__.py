"""ops of the PyTorch port (mirrors threedhumangan_tpu/ops)."""

from threedhumangan_tpu_torch.data.augment import grid_sample_bilinear as grid_sample  # noqa: F401
