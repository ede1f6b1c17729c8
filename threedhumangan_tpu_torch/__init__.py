"""threedhumangan_tpu_torch — PyTorch and CUDA port of threedhumangan_tpu.

The JAX package beside this one is the reference; this package reproduces
its pose-conditioned generation path (SMPL posing, mapping networks, the
FiLM-SIREN field render and the SPADE synthesis stack), its D+G+R1 training
step (mesh rasterization, the U-Net discriminator, losses, Adam, EMA) and
its training loop (``trainers/base_trainer.py``, ``apps/train.py``) in
PyTorch, with hand-written Hopper (sm_90a) kernels for the stages the JAX
package runs as Pallas kernels:

  ops/geo.py               K1  1-NN geo features      csrc/geo.cu
  ops/raymarch.py          K2  folded field render    csrc/raymarch.cu
  ops/synthesis_kernel.py  K3  fused SPADE synthesis  csrc/synthesis.cu
  ops/rasterize.py         K7  tile rasterizer        csrc/rasterize.cu
  ops/raymarch_bwd.py      K8  field-backward stats   csrc/raymarch_bwd.cu
                           K9  field-backward step    csrc/raymarch_bwd.cu
  ops/synthesis_train.py   K10 SPADE half-block fwd   csrc/synthesis_train.cu
                           K11 SPADE half-block bwd   csrc/synthesis_train.cu

Each kernel wrapper launches its kernel on a CUDA tensor and serves a CPU
tensor with a plain PyTorch version of the same math.  Module paths mirror
the JAX package; public functions keep its layouts (images NHWC, point
tensors (B, P, C)).  ``configs`` is this package's own copy of the JAX
package's configs; nothing here imports the JAX package.

Importing this package imports neither JAX nor a compiler: kernels are
built with nvcc at their first launch (``_build.py``).
"""

__version__ = "0.1.0"
