// The NFFT's window functions on the card, shared by the spreads
// (contract.cu) and the gather and position-gradient kernels (points.cuh):
// phi(t) in the scaled argument t = M x - cell and its derivative in the
// position, from the parameters of ops/window.py:window_params and
// window_deriv_param. The same float32 expressions as the plain PyTorch
// versions (ops/window.py).

#pragma once

#include <cuda_runtime.h>

namespace tnt {

struct Window {
  int kind;  // 0 gaussian, 1 es, 2 kb (ops/window.py:window_params)
  float p0, p1, p2;
};

// Modified Bessel I0 for x >= 0, Abramowitz-Stegun 9.8.1/9.8.2.
__device__ __forceinline__ float bessel_i0(float x) {
  if (x < 3.75f) {
    float y = x / 3.75f;
    y = y * y;
    return 1.0f + y * (3.5156229f + y * (3.0899424f + y * (1.2067492f +
           y * (0.2659732f + y * (0.0360768f + y * 0.0045813f)))));
  }
  const float z = 3.75f / x;
  const float p = 0.39894228f + z * (0.01328592f + z * (0.00225319f + z * (
      -0.00157565f + z * (0.00916281f + z * (-0.02057706f + z * (
      0.02635537f + z * (-0.01647633f + z * 0.00392377f)))))));
  return expf(x) * rsqrtf(x) * p;
}

__device__ __forceinline__ float phi(const Window& w, float t) {
  const float t2 = __fmul_rn(t, t);
  if (w.kind == 0) return expf(-t2 * w.p0) * w.p1;
  const float s2 = __fsub_rn(1.0f, __fmul_rn(t2, w.p1));
  if (!(s2 > 0.0f)) return 0.0f;
  const float s = sqrtf(s2);
  if (w.kind == 1) return expf(w.p0 * (s - 1.0f));
  return bessel_i0(w.p0 * s) * w.p2;
}

// Modified Bessel I1 for x >= 0, Abramowitz-Stegun 9.8.3/9.8.4.
__device__ __forceinline__ float bessel_i1(float x) {
  if (x < 3.75f) {
    float y = x / 3.75f;
    y = y * y;
    return x * (0.5f + y * (0.87890594f + y * (0.51498869f + y * (
        0.15084934f + y * (0.02658733f + y * (0.00301532f + y * 0.00032411f))))));
  }
  const float z = 3.75f / x;
  const float inner = 0.02282967f + z * (-0.02895312f + z * (0.01787654f - z * 0.00420059f));
  const float p = 0.39894228f + z * (-0.03988024f + z * (-0.00362018f + z * (
      0.00163801f + z * (-0.01031555f + z * inner))));
  return expf(x) * rsqrtf(x) * p;
}

// phi(t) and d phi / d pos = c t phi (gaussian), c t / s phi (es),
// c t / s I1(beta s) / I0(beta) (kb), with c = dcoef
// (ops/window.py:window_deriv_param) and 1/s clamped at s = 1e-6.
__device__ __forceinline__ void phi_and_deriv(const Window& w, float dcoef,
                                              float t, float* val,
                                              float* der) {
  const float t2 = __fmul_rn(t, t);
  if (w.kind == 0) {
    const float v = expf(-t2 * w.p0) * w.p1;
    *val = v;
    *der = dcoef * t * v;
    return;
  }
  const float s2 = __fsub_rn(1.0f, __fmul_rn(t2, w.p1));
  if (!(s2 > 0.0f)) {
    *val = 0.0f;
    *der = 0.0f;
    return;
  }
  const float s = sqrtf(s2);
  const float q = dcoef * t / fmaxf(s, 1e-6f);
  if (w.kind == 1) {
    const float v = expf(w.p0 * (s - 1.0f));
    *val = v;
    *der = q * v;
    return;
  }
  const float bs = w.p0 * s;
  *val = bessel_i0(bs) * w.p2;
  *der = q * bessel_i1(bs) * w.p2;
}

}  // namespace tnt
