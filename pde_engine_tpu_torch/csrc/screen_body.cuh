// Per-candidate screen body shared by the four CUDA screen kernels
// (screen_kernel.cu) and by the host build the CPU tests load
// (host_harness.cpp).
//
// Replaces the Pallas kernel body of pde_engine_tpu/parallel/
// pallas_engine.py (make_pallas_segmented/structured/tiled_kernel): the
// surface op at the screen order and at order 1, the fingerprint grid
// snap (search.snap_fp_jets), the PDE residual and its scale, and the
// fused verdict + compact packing (_verdict_pack_tile).  The body comes
// in per-point pieces: one screen point (screen_point), one fingerprint
// point (fp_point) and the verdict finish (verdict_finish).  group_lane
// runs one screen and one fingerprint point per lane of a candidate
// group (all four CUDA kernels, and the host harness's emulation of
// them); screen_candidate, built for the host harness only, runs them
// one after another in one thread, the reference the group body is held
// bit-equal to.
//
// The jet algebra itself is emitted from the shared Python jet code by
// pde_engine_tpu_torch/ops/cuda_emit.py into "jet_ops.h" (jet_apply_s,
// jet_apply_f, jet_residual and the JET_* sizes and constants).  It must
// be compiled without FMA contraction (nvcc -fmad=false, g++
// -ffp-contract=off) and without fast math, so that it rounds like eager
// float32 torch and the non-contracting TPU.
#pragma once

#include <math.h>
#include <stdint.h>
#include <string.h>

#ifdef __CUDACC__
#define JET_FN static __device__ __forceinline__
#define JET_UNROLL _Pragma("unroll")
#else
#define JET_FN static inline
#define JET_UNROLL
#endif

JET_FN uint32_t f2u(float x) { uint32_t u; memcpy(&u, &x, 4); return u; }
JET_FN float u2f(uint32_t u) { float x; memcpy(&x, &u, 4); return x; }
JET_FN bool jfinite(float x) { return (f2u(x) & 0x7F800000u) != 0x7F800000u; }
JET_FN float jet_nan() { return u2f(0x7FC00000u); }

// NaN-propagating min/max (jnp/torch.minimum semantics; fminf drops NaN).
JET_FN float jmin(float a, float b) {
  return (a != a || b != b) ? a + b : (a < b ? a : b);
}
JET_FN float jmax(float a, float b) {
  return (a != a || b != b) ? a + b : (a > b ? a : b);
}

#include "jet_ops.h"

// search.snap_fp_jets: round the mantissa to 11 explicit bits, ties to
// even, as integer bit-ops; |v| < 2^-126 flushes to +0, non-finite passes.
JET_FN float snap_fp(float v) {
  uint32_t b = f2u(v);
  uint32_t lsb = (b >> 12) & 1u;
  float s = u2f((b + 2047u + lsb) & 0xFFFFF000u);
  if (fabsf(v) < 0x1p-126f) s = 0.0f;
  return jfinite(v) ? s : v;
}

// search._quantize: (12-bit mantissa cell, exponent) key.  rintf rounds
// half to even like jnp.round; the +-4096 rollover renormalizes.
JET_FN uint32_t quantize(float v) {
  if (!jfinite(v)) v = JET_SENTINEL;
  int e;
  float m = frexpf(v, &e);
  int q = (int)rintf(m * 4096.0f);
  if (q == 4096 || q == -4096) {
    q >>= 1;
    e += 1;
  }
  int ec = e < -500 ? -500 : (e > 500 ? 500 : e);
  return (uint32_t)(q * 1024 + ec);
}

// The body in pieces.  The pieces' verdict parts merge with
// screen_merge / fp_merge, whose result does not depend on the order of
// the merges (the group kernels' reduction in screen_kernel.cu says
// why), so the pieces can run one after another in one thread
// (screen_candidate) or side by side on the lanes of a candidate group
// (the CUDA kernels).  Only the FNV folds depend on order.

// Verdict parts of some screen points.
struct ScreenAcc {
  bool any_inform;     // some point is informative (ok_pt)
  bool nonfinite_any;  // some point's residual or scale is not finite
  float rel_max;       // max of rel over the informative points, else 0
};

// Verdict parts of some fingerprint points.
struct FpAcc {
  bool fp_fin;     // every snapped coefficient is finite
  bool val_ok;     // every snapped value is finite
  float grad_max;  // max |gradient coefficient|, NaN if one is NaN
};

JET_FN ScreenAcc screen_acc0() { return ScreenAcc{false, false, 0.0f}; }
JET_FN FpAcc fp_acc0() { return FpAcc{true, true, 0.0f}; }

JET_FN ScreenAcc screen_merge(ScreenAcc x, ScreenAcc y) {
  return ScreenAcc{x.any_inform || y.any_inform,
                   x.nonfinite_any || y.nonfinite_any,
                   jmax(x.rel_max, y.rel_max)};
}

JET_FN FpAcc fp_merge(FpAcc x, FpAcc y) {
  return FpAcc{x.fp_fin && y.fp_fin, x.val_ok && y.val_ok,
               jmax(x.grad_max, y.grad_max)};
}

// One screen point: the op at the screen order on the point's operand
// jets ap, bp (T floats each; bp is not read by a unary op), the
// residual at (px, py) and the coefficient checks.  Writes the output
// jet to op_out (T floats).
JET_FN ScreenAcc screen_point(int op, const float* ap, const float* bp,
                              float px, float py, float* op_out) {
  float a[JET_T], b[JET_T], o[JET_T];
  JET_UNROLL
  for (int k = 0; k < JET_T; ++k) {
    a[k] = ap[k];
    b[k] = bp[k];
  }
  jet_apply_s(op, a, b, o);
  float res, scale;
  jet_residual(o, px, py, &res, &scale);
  bool coeff_ok = true, allzero = true;
  JET_UNROLL
  for (int k = 0; k < JET_T; ++k) {
    op_out[k] = o[k];
    float m = fabsf(o[k]);
    coeff_ok = coeff_ok && (m == 0.0f || m > JET_TINY);
    allzero = allzero && (m == 0.0f);
  }
  bool finite = jfinite(res) && jfinite(scale);
  bool structural = scale == 0.0f && res == 0.0f && coeff_ok && !allzero;
  bool ok_pt = finite && (scale > JET_SCALE_FLOOR || structural);
  float rel = fabsf(res) / (scale + JET_REL_EPS);
  return ScreenAcc{ok_pt, !finite, ok_pt ? rel : 0.0f};
}

// One fingerprint point: the op at order 1 on the point's operand jets
// ap, bp (3 floats each), snapped to the grid.  Writes the snapped jet to
// of_out and its three quantized keys, in coefficient order, to q.
JET_FN FpAcc fp_point(int op, const float* ap, const float* bp,
                      float* of_out, uint32_t* q) {
  float a[3], b[3], o[3];
  JET_UNROLL
  for (int k = 0; k < 3; ++k) {
    a[k] = ap[k];
    b[k] = bp[k];
  }
  jet_apply_f(op, a, b, o);
  JET_UNROLL
  for (int k = 0; k < 3; ++k) {
    o[k] = snap_fp(o[k]);
    of_out[k] = o[k];
    q[k] = quantize(o[k]);
  }
  return FpAcc{jfinite(o[0]) && jfinite(o[1]) && jfinite(o[2]),
               jfinite(o[0]), jmax(fabsf(o[1]), fabsf(o[2]))};
}

// The two FNV folds take the quantized keys in the order k = probe*3 +
// coeff.
JET_FN void fnv_fold(uint32_t* ha, uint32_t* hb, uint32_t q) {
  *ha = (*ha * JET_FNV_A_MULT) ^ q;
  *hb = (*hb * JET_FNV_B_MULT) ^ q;
}

// The verdict finish: flags, rel_max rounded up to bf16, and the three
// packed words fp_a, fp_b, rel_max | flags.
JET_FN void verdict_finish(ScreenAcc s, FpAcc f, float rtol, uint32_t ha,
                           uint32_t hb, uint32_t* packed) {
  float rel_max = s.any_inform ? s.rel_max : u2f(0x7F800000u);
  bool screen_ok = !s.nonfinite_any && s.any_inform && rel_max < rtol;
  bool is_const = f.grad_max == 0.0f && f.val_ok;
  uint32_t flags = (uint32_t)screen_ok | ((uint32_t)s.nonfinite_any << 1) |
                   ((uint32_t)is_const << 2) | ((uint32_t)f.fp_fin << 3);
  packed[0] = ha;
  packed[1] = hb;
  packed[2] = ((f2u(rel_max) + 0xFFFFu) & 0xFFFF0000u) | flags;
}

#ifndef __CUDACC__
// One candidate in one thread (host build only): a = (as, af), b = (bs,
// bf) are its operands' cache rows (point-major, P*T screen and F*3
// fingerprint floats).  Writes the screen jets (os), snapped fingerprint
// jets (of) and the three packed verdict words.
static void screen_candidate(int op, const float* as, const float* af,
                             const float* bs, const float* bf,
                             const float* spoints, float rtol, float* os,
                             float* of, uint32_t* packed) {
  ScreenAcc s = screen_acc0();
  for (int p = 0; p < JET_P; ++p)
    s = screen_merge(s, screen_point(op, as + p * JET_T, bs + p * JET_T,
                                     spoints[2 * p], spoints[2 * p + 1],
                                     os + p * JET_T));
  uint32_t ha = JET_FNV_A_SEED, hb = JET_FNV_B_SEED;
  FpAcc f = fp_acc0();
  for (int p = 0; p < JET_F; ++p) {
    uint32_t q[3];
    f = fp_merge(f, fp_point(op, af + 3 * p, bf + 3 * p, of + 3 * p, q));
    JET_UNROLL
    for (int k = 0; k < 3; ++k) fnv_fold(&ha, &hb, q[k]);
  }
  verdict_finish(s, f, rtol, ha, hb, packed);
}
#endif

// Lanes per candidate in the group body: the smallest power of two that
// is at least max(JET_P, JET_F) (8 for every problem of the repo).
#define JET_PF_MAX (JET_P > JET_F ? JET_P : JET_F)
#define JET_G                                                      \
  (JET_PF_MAX <= 1 ? 1 : JET_PF_MAX <= 2 ? 2 : JET_PF_MAX <= 4 ? 4 \
   : JET_PF_MAX <= 8 ? 8 : JET_PF_MAX <= 16 ? 16 : 32)
static_assert(JET_PF_MAX <= 32, "a candidate group must fit in a warp");

// What lane `lane` of a candidate group computes on its own: screen point
// `lane` if lane < P and fingerprint point `lane` if lane < F, each
// writing its slice of os / of.  A lane without a point returns the
// merge identity and zero keys.
JET_FN void group_lane(int op, int lane, const float* as, const float* af,
                       const float* bs, const float* bf, float px, float py,
                       float* os, float* of, ScreenAcc* s, FpAcc* f,
                       uint32_t* q) {
  *s = screen_acc0();
  *f = fp_acc0();
  q[0] = q[1] = q[2] = 0u;
  if (lane < JET_P)
    *s = screen_point(op, as + lane * JET_T, bs + lane * JET_T, px, py,
                      os + lane * JET_T);
  if (lane < JET_F)
    *f = fp_point(op, af + 3 * lane, bf + 3 * lane, of + 3 * lane, q);
}
