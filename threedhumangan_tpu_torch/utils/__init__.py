"""utils of the PyTorch port (mirrors threedhumangan_tpu/utils)."""
