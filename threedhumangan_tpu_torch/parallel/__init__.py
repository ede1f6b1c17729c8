"""Training statistics of the PyTorch port (mirrors threedhumangan_tpu/parallel)."""
