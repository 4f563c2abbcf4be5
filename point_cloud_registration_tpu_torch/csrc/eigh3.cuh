// The unit eigenvector of the smallest eigenvalue of a packed symmetric 3x3
// (c00 c11 c22 c01 c02 c12), in the arithmetic that ops/eigh3.py
// smallest_eigvec_sym3 has when PyTorch runs it on the card, so that a
// kernel's normals equal that function's bit for bit:
//
//   * every tensor operation rounds once: the _rn intrinsics keep nvcc from
//     contracting a product and a sum into one fused multiply-add;
//   * a tensor divided by a Python number is a product with the float32
//     reciprocal of the number (ATen's div_true_kernel_cuda: x / 3.0 is
//     x * (1.0f / 3.0f)); a tensor divided by a tensor is a true division;
//   * acosf, cosf, sqrtf and rsqrtf as ATen's kernels call them (::acos,
//     ::cos, ::sqrt and ::rsqrt of a float), with nvcc's IEEE defaults;
//   * torch.maximum / torch.minimum and torch.clamp pass a NaN on.
//
// The order of the operations is the Python source's, left to right.

#pragma once

namespace pcr {
namespace eigh3 {

constexpr float kEps = static_cast<float>(1e-20);  // _EPS of ops/eigh3.py
constexpr float kInv3 = 1.0f / 3.0f;
constexpr float kInv6 = 1.0f / 6.0f;
// two_pi_3 = 2.0 * math.pi / 3.0 in double, as the float an addition takes
constexpr float kTwoPi3 = static_cast<float>(2.0 * 3.14159265358979323846 / 3.0);

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ float div(float a, float b) { return __fdiv_rn(a, b); }

// torch.maximum / torch.minimum
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
// torch.clamp(v, min=lo) and torch.clamp(v, lo, hi)
__device__ __forceinline__ float clamp_min(float v, float lo) { return v != v ? v : fmaxf(v, lo); }
__device__ __forceinline__ float clamp(float v, float lo, float hi) {
  return v != v ? v : fminf(fmaxf(v, lo), hi);
}

// smallest_eigvec_sym3(s): _scaled6, the middle and largest eigenvalue of
// _eigvals_c, _projector_column_c(c, lam_hi, lam_mid) and _normalize_c with
// the +z fallback.
__device__ __forceinline__ void smallest_eigvec(const float (&s)[6], float& nx, float& ny,
                                                float& nz) {
  // _scaled6
  const float scale =
      tmax(tmax(tmax(fabsf(s[0]), fabsf(s[1])), tmax(fabsf(s[2]), fabsf(s[3]))),
           tmax(fabsf(s[4]), clamp_min(fabsf(s[5]), kEps)));
  const float a00 = div(s[0], scale), a11 = div(s[1], scale), a22 = div(s[2], scale);
  const float a01 = div(s[3], scale), a02 = div(s[4], scale), a12 = div(s[5], scale);

  // _eigvals_c
  const float q = mul(add(add(a00, a11), a22), kInv3);
  const float p1 = add(add(mul(a01, a01), mul(a02, a02)), mul(a12, a12));
  const float b00 = sub(a00, q), b11 = sub(a11, q), b22 = sub(a22, q);
  const float p2 = add(add(add(mul(b00, b00), mul(b11, b11)), mul(b22, b22)), mul(2.0f, p1));
  const float p = __fsqrt_rn(clamp_min(mul(p2, kInv6), kEps));
  const float detb = add(sub(mul(b00, sub(mul(b11, b22), mul(a12, a12))),
                             mul(a01, sub(mul(a01, b22), mul(a12, a02)))),
                         mul(a02, sub(mul(a01, a12), mul(b11, a02))));
  const float r = clamp(div(detb, mul(mul(mul(2.0f, p), p), p)), -1.0f, 1.0f);
  const float phi = mul(acosf(r), kInv3);
  float lam_hi = add(q, mul(mul(2.0f, p), cosf(phi)));
  const float lam_lo = add(q, mul(mul(2.0f, p), cosf(add(phi, kTwoPi3))));
  float lam_mid = sub(sub(mul(3.0f, q), lam_hi), lam_lo);
  const float d_lo = tmin(tmin(a00, a11), a22);
  const float d_hi = tmax(tmax(a00, a11), a22);
  const float d_mid = sub(sub(add(add(a00, a11), a22), d_lo), d_hi);
  const bool diag = p1 <= kEps;
  lam_mid = diag ? d_mid : lam_mid;
  lam_hi = diag ? d_hi : lam_hi;

  // _projector_column_c(c, lam_hi, lam_mid)
  const float t = add(lam_hi, lam_mid);
  const float d = mul(lam_hi, lam_mid);
  const float s00 = add(add(mul(a00, a00), mul(a01, a01)), mul(a02, a02));
  const float s11 = add(add(mul(a01, a01), mul(a11, a11)), mul(a12, a12));
  const float s22 = add(add(mul(a02, a02), mul(a12, a12)), mul(a22, a22));
  const float s01 = add(add(mul(a00, a01), mul(a01, a11)), mul(a02, a12));
  const float s02 = add(add(mul(a00, a02), mul(a01, a12)), mul(a02, a22));
  const float s12 = add(add(mul(a01, a02), mul(a11, a12)), mul(a12, a22));
  const float m00 = add(sub(s00, mul(t, a00)), d);
  const float m11 = add(sub(s11, mul(t, a11)), d);
  const float m22 = add(sub(s22, mul(t, a22)), d);
  const float m01 = sub(s01, mul(t, a01));
  const float m02 = sub(s02, mul(t, a02));
  const float m12 = sub(s12, mul(t, a12));
  const float n0 = add(add(mul(m00, m00), mul(m01, m01)), mul(m02, m02));
  const float n1 = add(add(mul(m01, m01), mul(m11, m11)), mul(m12, m12));
  const float n2 = add(add(mul(m02, m02), mul(m12, m12)), mul(m22, m22));
  const bool use1 = (n1 >= n0) && (n1 >= n2);
  const bool use2 = (n2 >= n0) && (n2 > n1);
  const float vx = use2 ? m02 : (use1 ? m01 : m00);
  const float vy = use2 ? m12 : (use1 ? m11 : m01);
  const float vz = use2 ? m22 : (use1 ? m12 : m02);

  // _normalize_c with the fallback (0, 0, 1)
  const float len2 = add(add(mul(vx, vx), mul(vy, vy)), mul(vz, vz));
  const bool ok = len2 > kEps;
  const float rs = rsqrtf(ok ? len2 : 1.0f);
  nx = ok ? mul(vx, rs) : 0.0f;
  ny = ok ? mul(vy, rs) : 0.0f;
  nz = ok ? mul(vz, rs) : 1.0f;
}

}  // namespace eigh3
}  // namespace pcr
