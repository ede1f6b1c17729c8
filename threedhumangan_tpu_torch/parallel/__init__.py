"""Data parallelism and training statistics of the PyTorch port (mirrors
threedhumangan_tpu/parallel): ``dist`` reduces across ranks, ``stats`` holds
the moments."""
