"""Plain PyTorch reference of the Map3D generator family, for the benchmark.

Written from the model's equations as the port states them (a frozen copy of
its plain math, restated per function), in float32 with TF32 off, with no
kernel, cache or batching of the port.  It imports nothing of
``threedhumangan_tpu_torch`` and nothing of JAX: the benchmark hands it the
same raw inputs (SMPL constants and pose parameters, weights, draws) that it
hands the program, and it works out the conditions, the field and the
images again.

``precision.Products`` rounds the operands of every product to one dtype
(float32: none); the control runs the same reference with float8 products.
"""
