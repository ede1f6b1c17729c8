// The SIREN's pointwise math shared by the field kernels K2 (raymarch.cu) and
// K4, K5, K8, K9 (field_core.cuh): the JAX package's sine, its derivative
// and FiLM, each rounded as the JAX kernels round it.
#pragma once

namespace thgt {

// the JAX package's degree-9 range-reduced sine (ops/raymarch.py::fast_sin)
constexpr float kSinC1 = 0.999979407588f, kSinC3 = -0.166624416001f, kSinC5 = 0.00830899784978f,
                kSinC7 = -0.000192651914745f, kSinC9 = 2.14797007513e-06f;

__device__ __forceinline__ float fast_sin(float x) {
  const float k = rintf(x * 0.15915494309189535f);
  const float y = x - k * 6.283185307179586f;
  const float y2 = y * y;
  return y * (kSinC1 + y2 * (kSinC3 + y2 * (kSinC5 + y2 * (kSinC7 + y2 * kSinC9))));
}

// exact derivative of fast_sin (ops/raymarch_bwd.py::fast_sin_grad)
__device__ __forceinline__ float fast_sin_grad(float x) {
  const float k = rintf(x * 0.15915494309189535f);
  const float y = x - k * 6.283185307179586f;
  const float y2 = y * y;
  return kSinC1 + y2 * (float(3.0 * -0.166624416001) +
                        y2 * (float(5.0 * 0.00830899784978) +
                              y2 * (float(7.0 * -0.000192651914745) + y2 * float(9.0 * 2.14797007513e-06))));
}

// FiLM f * v + p, rounded as two operations (the JAX order, no FMA)
__device__ __forceinline__ float film(float f, float v, float p) { return __fadd_rn(__fmul_rn(f, v), p); }

}  // namespace thgt
