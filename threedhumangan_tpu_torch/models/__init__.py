"""models of the PyTorch port (mirrors threedhumangan_tpu/models)."""
