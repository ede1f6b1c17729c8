"""threedhumangan_tpu_torch — PyTorch and CUDA port of threedhumangan_tpu.

The JAX package beside this one is the reference; this package reproduces
its pose-conditioned generation path (SMPL posing, mapping networks, the
FiLM-SIREN field render and the SPADE synthesis stack) in PyTorch, with
hand-written Hopper (sm_90a) kernels for the three stages the JAX package
runs as Pallas kernels:

  ops/geo.py               K1  1-NN geo features      csrc/geo.cu
  ops/raymarch.py          K2  folded field render    csrc/raymarch.cu
  ops/synthesis_kernel.py  K3  fused SPADE synthesis  csrc/synthesis.cu

Each kernel wrapper launches its kernel on a CUDA tensor and serves a CPU
tensor with a plain PyTorch version of the same math.  Module paths mirror
the JAX package; public functions keep its layouts (images NHWC, point
tensors (B, P, C)).  Configs are shared: ``configs`` re-exports
``threedhumangan_tpu.configs``, which is plain Python and imports no JAX.

Importing this package imports neither JAX nor a compiler: kernels are
built with nvcc at their first launch (``_build.py``).
"""

__version__ = "0.1.0"
