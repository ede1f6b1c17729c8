"""Trainers of the PyTorch port (mirrors threedhumangan_tpu/trainers)."""
