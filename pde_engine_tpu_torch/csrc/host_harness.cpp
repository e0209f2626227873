// Host (g++) build of the screen body, for the CPU tests: the same emitted
// jet algebra and hand-written verdict code the CUDA kernels run, called
// through ctypes on pre-gathered operand rows, both as the candidate group
// that all four CUDA kernels run, its warp shuffles emulated in lane
// order, and as one thread per candidate (screen_candidate, built only
// here), the reference the group is held bit-equal to.  Build with
// g++ -O2 -std=c++17 -ffp-contract=off -fPIC -shared (see
// pde_engine_tpu_torch/utils/cuda_build.py).

#include "screen_body.cuh"

#define SW (JET_P * JET_T)
#define FW (JET_F * 3)

extern "C" int host_dims(int* out) {
  out[0] = JET_T;
  out[1] = JET_P;
  out[2] = JET_F;
  out[3] = JET_N_OPS;
  return 0;
}

// Candidate i is ops[i](a_rows[i], b_rows[i]).
extern "C" void host_screen_rows(int n, const int* ops, const float* a_s,
                                 const float* a_f, const float* b_s,
                                 const float* b_f, const float* spoints,
                                 float rtol, float* out_s, float* out_f,
                                 uint32_t* packed) {
  for (long long i = 0; i < n; ++i)
    screen_candidate(ops[i], a_s + i * SW, a_f + i * FW, b_s + i * SW,
                     b_f + i * FW, spoints, rtol, out_s + i * SW,
                     out_f + i * FW, packed + 3 * i);
}

// Candidate i as the CUDA kernels screen it: group_lane on
// each of the JET_G lanes, then the kernels' __shfl_xor_sync butterfly
// (lane l merges with lane l ^ m, m = 1, 2, 4, ...) and the FNV gather
// of lane p's three keys for p = 0..F-1, read from lane 0.
extern "C" void host_screen_rows_grouped(int n, const int* ops,
                                         const float* a_s, const float* a_f,
                                         const float* b_s, const float* b_f,
                                         const float* spoints, float rtol,
                                         float* out_s, float* out_f,
                                         uint32_t* packed) {
  for (long long i = 0; i < n; ++i) {
    ScreenAcc s[JET_G], s2[JET_G];
    FpAcc f[JET_G], f2[JET_G];
    uint32_t q[JET_G][3];
    for (int lane = 0; lane < JET_G; ++lane) {
      float px = lane < JET_P ? spoints[2 * lane] : 0.0f;
      float py = lane < JET_P ? spoints[2 * lane + 1] : 0.0f;
      group_lane(ops[i], lane, a_s + i * SW, a_f + i * FW, b_s + i * SW,
                 b_f + i * FW, px, py, out_s + i * SW, out_f + i * FW,
                 &s[lane], &f[lane], q[lane]);
    }
    for (int m = 1; m < JET_G; m <<= 1) {
      for (int l = 0; l < JET_G; ++l) {
        s2[l] = screen_merge(s[l], s[l ^ m]);
        f2[l] = fp_merge(f[l], f[l ^ m]);
      }
      for (int l = 0; l < JET_G; ++l) {
        s[l] = s2[l];
        f[l] = f2[l];
      }
    }
    uint32_t ha = JET_FNV_A_SEED, hb = JET_FNV_B_SEED;
    for (int p = 0; p < JET_F; ++p)
      for (int k = 0; k < 3; ++k) fnv_fold(&ha, &hb, q[p][k]);
    verdict_finish(s[0], f[0], rtol, ha, hb, packed + 3 * i);
  }
}

// The residual alone: u is [n, P, T]; res and scale are [n, P].
extern "C" void host_residual(int n, const float* u, const float* spoints,
                              float* res, float* scale) {
  for (long long i = 0; i < n; ++i)
    for (int p = 0; p < JET_P; ++p)
      jet_residual(u + (i * JET_P + p) * JET_T, spoints[2 * p],
                   spoints[2 * p + 1], res + i * JET_P + p,
                   scale + i * JET_P + p);
}
