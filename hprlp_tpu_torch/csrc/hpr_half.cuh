// The HPR middle iteration's two half-updates of one entry, as the fused
// row writes of csrc/spmm.cu (batched) and csrc/spmv_csr.cu (single LP)
// compute them, and the rounding rules that keep them bitwise equal to
// PyTorch's elementwise kernels (solver/chunk.py::_x_half, _y_half;
// solver/batched.py::_bx_half, _by_half): each operation rounded once
// (__f*_rn / __d*_rn, never contracted into an fma), min and max taking
// NaN as torch.clamp and torch.maximum do.
#pragma once

namespace hprlp {

__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float sub_rn(float a, float b) {
  return __fadd_rn(a, -b);
}
__device__ __forceinline__ double sub_rn(double a, double b) {
  return __dadd_rn(a, -b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float div_rn(float a, float b) {
  return __fdiv_rn(a, b);
}
__device__ __forceinline__ double div_rn(double a, double b) {
  return __ddiv_rn(a, b);
}
__device__ __forceinline__ float fma_rn(float a, float b, float c) {
  return __fmaf_rn(a, b, c);
}
__device__ __forceinline__ double fma_rn(double a, double b, double c) {
  return __fma_rn(a, b, c);
}
// PyTorch's ::min / ::max on the card.
__device__ __forceinline__ float min_t(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double min_t(double a, double b) {
  return fmin(a, b);
}
__device__ __forceinline__ float max_t(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double max_t(double a, double b) {
  return fmax(a, b);
}

// The Halpern factor f1 = 1 / (k + 2) of counter k (f2 = 1 - f1), as
// _halpern_factors / _bfactors round it.
template <typename T>
__device__ __forceinline__ T halpern_f1(int k) {
  return div_rn(T(1), add_rn(static_cast<T>(k), T(2)));
}

// x-half: z = x + sigma (A^T y - c); x_bar = clamp(z, l, u);
// x_hat = 2 x_bar - x; returns x_new = f2 x_hat + f1 last_x.
template <typename T>
__device__ __forceinline__ T x_half_update(T aty, T x, T last, T c, T l,
                                           T u, T sigma, T f1, T& x_hat) {
  const T f2 = sub_rn(T(1), f1);
  const T z = add_rn(x, mul_rn(sigma, sub_rn(aty, c)));
  const T xb = z != z ? z : min_t(max_t(z, l), u);
  x_hat = sub_rn(mul_rn(T(2), xb), x);
  return add_rn(mul_rn(f2, x_hat), mul_rn(f1, last));
}

// y-half: v = A x_hat - lam_sigma y; d = max(AL - v, min(AU - v, 0));
// y_bar = d / lam_sigma; y_hat = 2 y_bar - y; returns
// y_new = f2 y_hat + f1 last_y.
template <typename T>
__device__ __forceinline__ T y_half_update(T ax, T y, T last, T al, T au,
                                           T lam_sigma, T f1) {
  const T f2 = sub_rn(T(1), f1);
  const T v = sub_rn(ax, mul_rn(lam_sigma, y));
  const T lo = sub_rn(al, v);
  const T up = sub_rn(au, v);
  const T m = up != up ? up : min_t(up, T(0));
  const T d = lo != lo ? lo : (m != m ? m : max_t(lo, m));
  const T yh = sub_rn(mul_rn(T(2), div_rn(d, lam_sigma)), y);
  return add_rn(mul_rn(f2, yh), mul_rn(f1, last));
}

}  // namespace hprlp
