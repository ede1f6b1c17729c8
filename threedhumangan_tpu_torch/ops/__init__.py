"""ops of the PyTorch port (mirrors threedhumangan_tpu/ops)."""
