"""data of the PyTorch port (mirrors threedhumangan_tpu/data)."""
