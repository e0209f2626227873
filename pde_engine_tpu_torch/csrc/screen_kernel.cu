// Hand-written Hopper screen kernels: four operand addressing modes over
// the device jet cache, one shared body (screen_body.cuh).
//
// Replaces, in pde_engine_tpu/parallel/pallas_engine.py:
//   segmented_kernel   <- make_pallas_segmented_kernel (per-row ab_idx;
//                         its op id per 512-candidate tile comes here as
//                         one op id per row, so no tile is padded)
//   structured_kernel  <- make_pallas_structured_kernel (one op, one
//                         constant row, the contiguous rows big0 + i)
//   tiled_kernel       <- make_pallas_tiled_kernel (per 512-tile opkind =
//                         op*2 + kind, contiguous start, constant uid)
//   universal_kernel   <- _op_tile_runner via make_pallas_universal_kernel /
//                         make_pallas_op_kernel (per-row ab_idx, one op id
//                         for the whole launch; snap, verdict and pack,
//                         which the JAX kernel leaves to XLA, run fused
//                         here as in the other three)
//
// What bounds them on the H100 (NVIDIA H100 80GB HBM3, 700 W; PERF.md,
// from chip_smoke.py and from variants of the kernels timed on the card
// with the operand rows kept in L1 or the stores suppressed).
// Per candidate the work is two 552-byte operand rows in (120 screen +
// 18 fingerprint floats for force_free), a 552-byte row plus 12 bytes of
// verdicts out, and 3,178-9,584 emitted float32 operations: the bytes
// side of the roofline is the larger (about 0.1 ms per 262,144
// candidates).  A body that runs one candidate per thread writes its
// rows one float at a time with the 32 lanes of a warp a row apart, so
// every store instruction of the warp touches 32 sectors: those stores
// set its pace (0.90 ms per 262,144 random candidates, 0.20 ms with the
// stores suppressed).  All four kernels are built around that:
//   - a candidate group: G lanes (JET_G, 8 for P=8, F=6) share one
//     candidate; lane p runs screen point p and fingerprint point p, and
//     the group's verdict parts are reduced with warp shuffles;
//   - staged rows: a block screens up to 128 candidates in steps of
//     kStep = 128 / G; each step's operand rows are copied into shared
//     memory two steps ahead (a two-stage ring), so the next step's
//     copies overlap this step's arithmetic; the copies are cached in L1
//     (.ca), so a row that many candidates share is not fetched from one
//     L2 slice by every block at once;
//       gathered rows (segmented, universal: per-row operands): the
//       block stages its clamped row ids, and neighbouring lanes copy a
//       row in 16-byte (screen) and 8-byte (fingerprint) cp.async chunks;
//       contiguous rows (tiled, structured: a run and a constant row):
//       the constant row is loaded once per block and the run by one TMA
//       bulk copy per step (cp.async.bulk, completing on an mbarrier);
//   - staged outputs: the step's output rows are contiguous in out_s /
//     out_f / packed, and leave shared memory in coalesced 16-byte
//     stores;
//   - no pad rows: segmented takes one op id per row, so the caller packs
//     each op's candidates back to back and launches exactly them;
//     universal launches exactly its rows; tiled screens whole 512-row
//     tiles of a run, and only the tiles the caller filled.
// What bounds them now is instruction issue for the jet arithmetic:
// about 0.21 ms per 262,144 random candidates, 0.18 ms with no HBM
// traffic and no stores (about twice the bytes bound).  ptxas gives the
// group kernels about 128 registers (4 blocks of 128 threads per SM) and
// no spills; asking for 5 blocks (96 registers) did not help.
//
// Blocks follow the launch size.  A block's steps run one after another,
// so a launch with fewer blocks than the card holds at once (132 SMs x
// blocks per SM) takes one block's steps whatever its rows: the
// per-op path's universal launches hold about 500 rows, structured's at
// --batch-size 4096 hold 4,096.  structured and universal therefore take
// their candidates per block (16, 32, 64 or 128: 1-8 steps) from the
// caller, which picks the largest whose grid still fills the card
// (cuda_engine.candidates_per_block, from pde_screen_geometry); segmented
// and tiled keep 128.
//
// Op ids are uniform over a 512-candidate tile in tiled_kernel and over
// the whole launch in structured and universal, hence over every warp,
// so the op switch does not diverge there; in segmented_kernel it
// diverges only in a warp where one op's run ends.
//
// Build: nvcc -O3 -std=c++17 -gencode arch=compute_90a,code=sm_90a
//        -fmad=false -Xcompiler -fPIC -shared (pde_engine_tpu_torch/utils/
//        cuda_build.py), with the emitted jet_ops.h on the include path.

#include <cuda_runtime.h>

#include "screen_body.cuh"

#define TILE 512
#define SW (JET_P * JET_T)
#define FW (JET_F * 3)

static __device__ __forceinline__ long long clamp_row(long long r,
                                                      long long cap) {
  return r < 0 ? 0 : (r >= cap ? cap - 1 : r);
}

constexpr int kGroupThreads = 128;            // threads per block
// universal's blocks per SM (at most 128 registers a thread): left to
// ptxas's heuristic, grad_shafranov's build took 96 registers and
// spilled.  The other kernels keep the heuristic's choice (with a
// minimum of 4, force_free's tiled spills at 128).
constexpr int kUniversalMinBlocks = 4;
constexpr int kStep = kGroupThreads / JET_G;  // candidates per step
constexpr int kBlockCands = 128;              // most candidates per block
constexpr unsigned kFull = 0xFFFFFFFFu;
static_assert(32 % JET_G == 0, "candidate groups tile a warp");
static_assert(TILE % kBlockCands == 0, "a block lies in one 512-row tile");
static_assert(kBlockCands % kStep == 0, "whole steps");
static_assert(kStep % 4 == 0, "a step's packed words are whole 16 B");
static_assert(SW % 4 == 0, "screen rows are whole 16-byte chunks");
static_assert(FW % 2 == 0, "fingerprint rows are whole 8-byte chunks");

// Shared-row pitch.  Rows are staged at their own width (SW, FW floats),
// back to back, so that the rows of a contiguous run are one bulk copy
// and every screen row starts 16-byte aligned (SW * 4 = 480 B for
// force_free).  Lane l = c*G + p of a warp (candidate c of the warp's
// 32/G, point p) reads coefficient k of its screen point at word
// c*SW + p*T + k = (c*P + p)*T + k when G = P, i.e. bank (l*T + k) mod
// 32: the 32 lanes hit 32 banks whenever T is odd (T = 15 at order 4),
// and with G > P the active lanes' c*P + p are still distinct.  The
// fingerprint reads are word 3*(c*F + p) + k, likewise conflict-free.
// At order 2 (T = 6) the screen reads are 2-way conflicted; no order-2
// problem is on the main path.

static __device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// Cached in L1 as well as L2 (.ca): an operand row that many candidates
// share (a depth-1 leaf) is then fetched once per SM, not once per block
// step from one L2 slice.
static __device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

static __device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

static __device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// All but the most recent committed group have landed.
static __device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

static __device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

static __device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

static __device__ __forceinline__ void mbar_arrive_tx(uint64_t* bar,
                                                      unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

static __device__ __forceinline__ void mbar_wait(uint64_t* bar,
                                                 unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA bulk copy of `bytes` contiguous bytes into shared memory,
// completing on `bar`.
static __device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                                 unsigned bytes,
                                                 uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

static __device__ __forceinline__ ScreenAcc shfl_xor(ScreenAcc x, int m) {
  return ScreenAcc{__shfl_xor_sync(kFull, (int)x.any_inform, m) != 0,
                   __shfl_xor_sync(kFull, (int)x.nonfinite_any, m) != 0,
                   __shfl_xor_sync(kFull, x.rel_max, m)};
}

static __device__ __forceinline__ FpAcc shfl_xor(FpAcc x, int m) {
  return FpAcc{__shfl_xor_sync(kFull, (int)x.fp_fin, m) != 0,
               __shfl_xor_sync(kFull, (int)x.val_ok, m) != 0,
               __shfl_xor_sync(kFull, x.grad_max, m)};
}

// One candidate on the G lanes of its group (lane = its index in the
// group): the operand rows as/af, bs/bf and the output rows os/of are
// the candidate's staged rows; the first lane writes its three packed
// words to pk.
//
// The reduction merges lane l with lane l ^ m for m = 1, 2, 4, ..., so
// the merge order differs from screen_candidate's (the host harness's
// one-thread body), and the result does not: any_inform, nonfinite_any,
// fp_fin and val_ok are ORs and ANDs; rel is never NaN where ok_pt holds
// (a finite |res| over scale + eps > 0) and is 0 where it does not, so
// rel_max is the max of non-NaN values; a NaN grad_max may carry another
// payload, but grad_max only feeds grad_max == 0, false for every NaN.
// The FNV folds depend on order (k = probe*3 + coeff): every lane of the
// group gathers the 3F keys from lanes 0..F-1 with __shfl_sync and folds
// them in that order.
static __device__ __forceinline__ void group_screen(
    int op, int lane, const float* as, const float* af, const float* bs,
    const float* bf, float px, float py, float rtol, float* os, float* of,
    uint32_t* pk) {
  ScreenAcc s;
  FpAcc f;
  uint32_t q[3];
  group_lane(op, lane, as, af, bs, bf, px, py, os, of, &s, &f, q);
#pragma unroll
  for (int m = 1; m < JET_G; m <<= 1) {
    s = screen_merge(s, shfl_xor(s, m));
    f = fp_merge(f, shfl_xor(f, m));
  }
  const int first = (int)(threadIdx.x & 31u) & ~(JET_G - 1);
  uint32_t ha = JET_FNV_A_SEED, hb = JET_FNV_B_SEED;
#pragma unroll
  for (int p = 0; p < JET_F; ++p) {
#pragma unroll
    for (int k = 0; k < 3; ++k)
      fnv_fold(&ha, &hb, __shfl_sync(kFull, q[k], first + p));
  }
  if (lane == 0) verdict_finish(s, f, rtol, ha, hb, pk);
}

// The first m output rows of one step, contiguous in out_s / out_f /
// packed from candidate i0 on, leave shared memory in 16-byte stores (a
// step of fewer than kStep rows, the last of a gathered launch, stores
// its fingerprint rows and packed words 4 bytes at a time).
static __device__ __forceinline__ void store_step(
    long long i0, int m, const float* o_s, const float* o_f,
    const uint32_t* o_p, float* out_s, float* out_f, uint32_t* packed) {
  const int tid = threadIdx.x;
  float4* gs = reinterpret_cast<float4*>(out_s + i0 * SW);
  const float4* ss = reinterpret_cast<const float4*>(o_s);
  for (int j = tid; j < m * SW / 4; j += kGroupThreads) gs[j] = ss[j];
  if (m < kStep) {
    for (int j = tid; j < m * FW; j += kGroupThreads)
      out_f[i0 * FW + j] = o_f[j];
    for (int j = tid; j < m * 3; j += kGroupThreads)
      packed[3 * i0 + j] = o_p[j];
    return;
  }
  float4* gf = reinterpret_cast<float4*>(out_f + i0 * FW);
  const float4* sf = reinterpret_cast<const float4*>(o_f);
  for (int j = tid; j < kStep * FW / 4; j += kGroupThreads) gf[j] = sf[j];
  uint4* gp = reinterpret_cast<uint4*>(packed + 3 * i0);
  const uint4* sp = reinterpret_cast<const uint4*>(o_p);
  for (int j = tid; j < kStep * 3 / 4; j += kGroupThreads) gp[j] = sp[j];
}

// ---------------------------------------------------------------------------
// Gathered rows: segmented and universal
// ---------------------------------------------------------------------------

// Shared memory of the gathered kernels, in 4-byte words: a two-stage
// ring of a and b operand rows (screen, then fingerprint), one step's
// output rows, the block's clamped operand row ids and, in segmented,
// its op ids.
constexpr int kGatStageS = 2 * kStep * SW;  // a rows, then b rows
constexpr int kGatStageF = 2 * kStep * FW;
constexpr size_t kUniSmem =
    4 * (size_t)(2 * kGatStageS + 2 * kGatStageF + kStep * SW + kStep * FW +
                 kStep * 3 + 2 * kBlockCands);
constexpr size_t kSegSmem = kUniSmem + 4 * (size_t)kBlockCands;

// One block of a gathered launch: rows [blk0, blk0 + cands) clipped to n,
// blk0 = blockIdx.x * cands, in whole steps; the rows of its last step
// past n repeat row n - 1 and are not stored.  kRowOps: candidate i is
// op row_ops[i] (segmented); otherwise every candidate is op op_all
// (universal), and a unary op's b rows are neither staged nor fetched.
template <bool kRowOps>
static __device__ __forceinline__ void gathered_block(
    const float* __restrict__ cache_s, const float* __restrict__ cache_f,
    long long cap, const int* __restrict__ ab,
    const int* __restrict__ row_ops, int op_all,
    const float* __restrict__ spoints, float rtol, int n, int cands,
    float* __restrict__ out_s, float* __restrict__ out_f,
    uint32_t* __restrict__ packed) {
  extern __shared__ float4 smem4[];
  float* st_s = reinterpret_cast<float*>(smem4);
  float* st_f = st_s + 2 * kGatStageS;
  float* o_s = st_f + 2 * kGatStageF;
  float* o_f = o_s + kStep * SW;
  uint32_t* o_p = reinterpret_cast<uint32_t*>(o_f + kStep * FW);
  int* rows = reinterpret_cast<int*>(o_p + kStep * 3);
  int* ops = rows + 2 * kBlockCands;  // kRowOps only

  const int tid = threadIdx.x;
  const long long blk0 = (long long)blockIdx.x * cands;
  if (blk0 >= n) return;
  const int live = (int)(n - blk0 < cands ? n - blk0 : cands);
  const int steps = (live + kStep - 1) / kStep;
  const bool b_rows = kRowOps || op_all >= JET_N_UNARY;
  const int g = tid / JET_G, lane = tid % JET_G;
  const float px = lane < JET_P ? spoints[2 * lane] : 0.0f;
  const float py = lane < JET_P ? spoints[2 * lane + 1] : 0.0f;

  for (int j = tid; j < steps * kStep; j += kGroupThreads) {
    const long long i = blk0 + (j < live ? j : live - 1);
    rows[j] = (int)clamp_row(ab[2 * i], cap);
    if (b_rows) rows[kBlockCands + j] = (int)clamp_row(ab[2 * i + 1], cap);
    if (kRowOps) ops[j] = row_ops[i];
  }
  __syncthreads();

  // Copy step `step`'s operand rows into ring slot `buf`: neighbouring
  // threads take neighbouring chunks of a row; a unary candidate's b row
  // is not fetched.
  auto gather = [&](int step, int buf) {
    float* ds = st_s + buf * kGatStageS;
    float* df = st_f + buf * kGatStageF;
    const int c0 = step * kStep;
    const int n_rows = b_rows ? 2 * kStep : kStep;
    for (int j = tid; j < n_rows * (SW / 4); j += kGroupThreads) {
      const int r = j / (SW / 4), c = j - r * (SW / 4);
      const int w = r / kStep, cand = c0 + (r - w * kStep);
      if (kRowOps && w && ops[cand] < JET_N_UNARY) continue;
      const long long row = rows[w * kBlockCands + cand];
      cp_async16(ds + r * SW + 4 * c, cache_s + row * SW + 4 * c);
    }
    for (int j = tid; j < n_rows * (FW / 2); j += kGroupThreads) {
      const int r = j / (FW / 2), c = j - r * (FW / 2);
      const int w = r / kStep, cand = c0 + (r - w * kStep);
      if (kRowOps && w && ops[cand] < JET_N_UNARY) continue;
      const long long row = rows[w * kBlockCands + cand];
      cp_async8(df + r * FW + 2 * c, cache_f + row * FW + 2 * c);
    }
  };

  gather(0, 0);
  cp_async_commit();
  if (steps > 1) gather(1, 1);
  cp_async_commit();  // possibly empty: keeps one group per step
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    cp_async_wait_prev();
    __syncthreads();
    const int op = kRowOps ? ops[step * kStep + g] : op_all;
    const bool binary = op >= JET_N_UNARY;
    const float* as = st_s + buf * kGatStageS + g * SW;
    const float* af = st_f + buf * kGatStageF + g * FW;
    group_screen(op, lane, as, af, binary ? as + kStep * SW : as,
                 binary ? af + kStep * FW : af, px, py, rtol, o_s + g * SW,
                 o_f + g * FW, o_p + 3 * g);
    __syncthreads();
    const int m = live - step * kStep;
    store_step(blk0 + step * kStep, m < kStep ? m : kStep, o_s, o_f, o_p,
               out_s, out_f, packed);
    if (step + 2 < steps) gather(step + 2, buf);
    cp_async_commit();
  }
}

// Mixed ops, one op id per row (row_ops), per-row operands ab, any n, 128
// candidates per block.  The caller packs each op's candidates back to
// back, so a warp straddles two ops only where one op's run ends inside
// it, and only that warp runs the op switch twice.
__global__ void __launch_bounds__(kGroupThreads)
    segmented_kernel(const float* __restrict__ cache_s,
                     const float* __restrict__ cache_f, long long cap,
                     const int* __restrict__ ab,
                     const int* __restrict__ row_ops,
                     const float* __restrict__ spoints, float rtol, int n,
                     float* __restrict__ out_s, float* __restrict__ out_f,
                     uint32_t* __restrict__ packed) {
  gathered_block<true>(cache_s, cache_f, cap, ab, row_ops, 0, spoints, rtol,
                       n, kBlockCands, out_s, out_f, packed);
}

// One op for the whole launch, per-row operands (the per-op engine path
// and its resume replay), any n, `cands` candidates per block.
__global__ void __launch_bounds__(kGroupThreads, kUniversalMinBlocks)
    universal_kernel(const float* __restrict__ cache_s,
                     const float* __restrict__ cache_f, long long cap,
                     const int* __restrict__ ab, int op,
                     const float* __restrict__ spoints, float rtol, int n,
                     int cands, float* __restrict__ out_s,
                     float* __restrict__ out_f,
                     uint32_t* __restrict__ packed) {
  gathered_block<false>(cache_s, cache_f, cap, ab, nullptr, op, spoints,
                        rtol, n, cands, out_s, out_f, packed);
}

// ---------------------------------------------------------------------------
// Contiguous rows: tiled and structured
// ---------------------------------------------------------------------------

// Shared memory of the contiguous kernels: two mbarriers (16 B), a
// two-stage ring of the run's rows, the constant row, one step's output
// rows.
constexpr int kConStageS = kStep * SW;
constexpr int kConStageF = kStep * FW;
constexpr int kFW4 = (FW + 3) / 4 * 4;
constexpr size_t kConSmem =
    16 + 4 * (size_t)(2 * kConStageS + 2 * kConStageF + SW + kFW4 +
                      kStep * SW + kStep * FW + kStep * 3);

// One block of a contiguous launch: candidates [blk0, blk0 + cands), all
// of them live, in cands / kStep steps; candidate blk0 + i is op `op` on
// the run's row run0 + i and the constant row const_uid (operand b, or a
// when run_is_b; unary ops take the run as operand a and no constant).
static __device__ __forceinline__ void contiguous_block(
    const float* __restrict__ cache_s, const float* __restrict__ cache_f,
    long long cap, int op, bool run_is_b, long long run0, int const_uid,
    const float* __restrict__ spoints, float rtol, long long blk0,
    int cands, float* __restrict__ out_s, float* __restrict__ out_f,
    uint32_t* __restrict__ packed) {
  extern __shared__ float4 smem4[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem4);
  float* st_s = reinterpret_cast<float*>(smem4 + 1);
  float* st_f = st_s + 2 * kConStageS;
  float* c_s = st_f + 2 * kConStageF;
  float* c_f = c_s + SW;
  float* o_s = c_f + kFW4;
  float* o_f = o_s + kStep * SW;
  uint32_t* o_p = reinterpret_cast<uint32_t*>(o_f + kStep * FW);

  const int tid = threadIdx.x;
  const int steps = cands / kStep;
  const bool binary = op >= JET_N_UNARY;
  const bool swap = run_is_b && binary;
  const int g = tid / JET_G, lane = tid % JET_G;
  const float px = lane < JET_P ? spoints[2 * lane] : 0.0f;
  const float py = lane < JET_P ? spoints[2 * lane + 1] : 0.0f;

  if (tid == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (binary) {  // the constant row, once per block (in the first group)
    const long long rc = clamp_row(const_uid, cap);
    for (int j = tid; j < SW / 4; j += kGroupThreads)
      cp_async16(c_s + 4 * j, cache_s + rc * SW + 4 * j);
    for (int j = tid; j < FW / 2; j += kGroupThreads)
      cp_async8(c_f + 2 * j, cache_f + rc * FW + 2 * j);
  }
  __syncthreads();

  // Step `step`'s rows of the run into ring slot `buf`: the screen rows in
  // one bulk copy (per-row copies where the run would leave the cache
  // and clamps), the fingerprint rows (8-byte aligned only) in 8-byte
  // chunks.
  auto fetch = [&](int step, int buf) {
    const long long r0 = run0 + step * kStep;
    float* ds = st_s + buf * kConStageS;
    float* df = st_f + buf * kConStageF;
    if (r0 >= 0 && r0 + kStep <= cap) {
      if (tid == 0) {
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        mbar_arrive_tx(&bars[buf], 4u * kConStageS);
        bulk_load(ds, cache_s + r0 * SW, 4u * kConStageS, &bars[buf]);
      }
    } else {
      for (int j = tid; j < kStep * (SW / 4); j += kGroupThreads) {
        const int r = j / (SW / 4), c = j - r * (SW / 4);
        cp_async16(ds + r * SW + 4 * c,
                   cache_s + clamp_row(r0 + r, cap) * SW + 4 * c);
      }
      if (tid == 0) mbar_arrive(&bars[buf]);
    }
    for (int j = tid; j < kStep * (FW / 2); j += kGroupThreads) {
      const int r = j / (FW / 2), c = j - r * (FW / 2);
      cp_async8(df + r * FW + 2 * c,
                cache_f + clamp_row(r0 + r, cap) * FW + 2 * c);
    }
  };

  // Slot buf serves steps buf, buf + 2, ...: its barrier completes once
  // per use, so step s waits on phase parity (s / 2) & 1, for any count.
  fetch(0, 0);
  cp_async_commit();
  if (steps > 1) fetch(1, 1);
  cp_async_commit();  // possibly empty: keeps one group per step
  for (int step = 0; step < steps; ++step) {
    const int buf = step & 1;
    cp_async_wait_prev();
    mbar_wait(&bars[buf], (unsigned)(step >> 1) & 1u);
    __syncthreads();
    const float* rs = st_s + buf * kConStageS + g * SW;
    const float* rf = st_f + buf * kConStageF + g * FW;
    const float* as = swap ? c_s : rs;
    const float* af = swap ? c_f : rf;
    const float* bs = binary ? (swap ? rs : c_s) : as;
    const float* bf = binary ? (swap ? rf : c_f) : af;
    group_screen(op, lane, as, af, bs, bf, px, py, rtol, o_s + g * SW,
                 o_f + g * FW, o_p + 3 * g);
    __syncthreads();
    store_step(blk0 + step * kStep, kStep, o_s, o_f, o_p, out_s, out_f,
               packed);
    if (step + 2 < steps) fetch(step + 2, buf);
    cp_async_commit();
  }
}

// opkind[t] = op*2 + kind per 512-tile; kind 1: the contiguous rows are
// operand b (constant a).  128 candidates per block, four per tile.
__global__ void __launch_bounds__(kGroupThreads)
    tiled_kernel(const float* __restrict__ cache_s,
                 const float* __restrict__ cache_f, long long cap,
                 const int* __restrict__ starts,
                 const int* __restrict__ const_uid,
                 const int* __restrict__ opkind,
                 const float* __restrict__ spoints, float rtol, int n,
                 float* __restrict__ out_s, float* __restrict__ out_f,
                 uint32_t* __restrict__ packed) {
  const long long blk0 = (long long)blockIdx.x * kBlockCands;
  if (blk0 >= n) return;
  const long long t = blk0 / TILE;
  const int ok = opkind[t];
  contiguous_block(cache_s, cache_f, cap, ok >> 1, (ok & 1) != 0,
                   (long long)starts[t] + (blk0 % TILE), const_uid[t],
                   spoints, rtol, blk0, kBlockCands, out_s, out_f, packed);
}

// One op, the constant row const_uid and the contiguous rows big0 + i;
// big_is_b: the run is operand b.  `cands` candidates per block, a
// divisor of n.
__global__ void __launch_bounds__(kGroupThreads)
    structured_kernel(const float* __restrict__ cache_s,
                      const float* __restrict__ cache_f, long long cap,
                      int const_uid, int big0, int op, int big_is_b,
                      const float* __restrict__ spoints, float rtol, int n,
                      int cands, float* __restrict__ out_s,
                      float* __restrict__ out_f,
                      uint32_t* __restrict__ packed) {
  const long long blk0 = (long long)blockIdx.x * cands;
  if (blk0 >= n) return;
  contiguous_block(cache_s, cache_f, cap, op, big_is_b != 0,
                   (long long)big0 + blk0, const_uid, spoints, rtol, blk0,
                   cands, out_s, out_f, packed);
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

// Above 48 KB a kernel's dynamic shared memory must be opted into.
static int allow_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// A candidates-per-block count the kernels take: whole steps, at most
// kBlockCands, a power of two (so it divides the 512-row tile).
static bool good_cands(int cands) {
  return cands >= kStep && cands <= kBlockCands && cands % kStep == 0 &&
         (cands & (cands - 1)) == 0;
}

extern "C" int pde_screen_dims(int* out) {
  out[0] = JET_T;
  out[1] = JET_P;
  out[2] = JET_F;
  out[3] = JET_N_OPS;
  return 0;
}

// The launch geometry, in the order segmented, structured, tiled,
// universal: out[0..3] dynamic shared memory per block (bytes), out[4..7]
// blocks resident on one SM at that shared memory
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), out[8] the current
// device's SMs, out[9] lanes per candidate group, out[10] candidates per
// step.
extern "C" int pde_screen_geometry(int* out) {
  const void* fns[4] = {(const void*)segmented_kernel,
                        (const void*)structured_kernel,
                        (const void*)tiled_kernel,
                        (const void*)universal_kernel};
  const size_t smem[4] = {kSegSmem, kConSmem, kConSmem, kUniSmem};
  for (int k = 0; k < 4; ++k) {
    out[k] = (int)smem[k];
    int rc = allow_smem(fns[k], smem[k]);
    if (rc) return rc;
    rc = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &out[4 + k], fns[k], kGroupThreads, smem[k]);
    if (rc) return rc;
  }
  int dev = 0;
  int rc = (int)cudaGetDevice(&dev);
  if (rc) return rc;
  rc = (int)cudaDeviceGetAttribute(&out[8], cudaDevAttrMultiProcessorCount,
                                   dev);
  out[9] = JET_G;
  out[10] = kStep;
  return rc;
}

// n: the rows of ab and row_ops, any count.
extern "C" int pde_screen_segmented(const float* cache_s,
                                    const float* cache_f, long long cap,
                                    const int* ab, const int* row_ops,
                                    const float* spoints, float rtol, int n,
                                    float* out_s, float* out_f,
                                    uint32_t* packed, void* stream) {
  if (n <= 0) return n ? (int)cudaErrorInvalidValue : 0;
  int rc = allow_smem((const void*)segmented_kernel, kSegSmem);
  if (rc) return rc;
  segmented_kernel<<<(n + kBlockCands - 1) / kBlockCands, kGroupThreads,
                     kSegSmem, (cudaStream_t)stream>>>(
      cache_s, cache_f, cap, ab, row_ops, spoints, rtol, n, out_s, out_f,
      packed);
  return (int)cudaGetLastError();
}

// n: a multiple of the 512-row tile; cands: candidates per block.
extern "C" int pde_screen_structured(const float* cache_s,
                                     const float* cache_f, long long cap,
                                     int const_uid, int big0, int op,
                                     int big_is_b, const float* spoints,
                                     float rtol, int n, int cands,
                                     float* out_s, float* out_f,
                                     uint32_t* packed, void* stream) {
  if (n < 0 || n % TILE || !good_cands(cands))
    return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  int rc = allow_smem((const void*)structured_kernel, kConSmem);
  if (rc) return rc;
  structured_kernel<<<n / cands, kGroupThreads, kConSmem,
                      (cudaStream_t)stream>>>(
      cache_s, cache_f, cap, const_uid, big0, op, big_is_b, spoints, rtol, n,
      cands, out_s, out_f, packed);
  return (int)cudaGetLastError();
}

// n: the rows of the launch, one 512-row tile per entry of starts,
// const_uid and opkind.
extern "C" int pde_screen_tiled(const float* cache_s, const float* cache_f,
                                long long cap, const int* starts,
                                const int* const_uid, const int* opkind,
                                const float* spoints, float rtol, int n,
                                float* out_s, float* out_f, uint32_t* packed,
                                void* stream) {
  if (n % TILE) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  int rc = allow_smem((const void*)tiled_kernel, kConSmem);
  if (rc) return rc;
  tiled_kernel<<<n / kBlockCands, kGroupThreads, kConSmem,
                 (cudaStream_t)stream>>>(cache_s, cache_f, cap, starts,
                                         const_uid, opkind, spoints, rtol, n,
                                         out_s, out_f, packed);
  return (int)cudaGetLastError();
}

// n: the rows of ab, any count; cands: candidates per block.
extern "C" int pde_screen_universal(const float* cache_s,
                                    const float* cache_f, long long cap,
                                    const int* ab, int op,
                                    const float* spoints, float rtol, int n,
                                    int cands, float* out_s, float* out_f,
                                    uint32_t* packed, void* stream) {
  if (n < 0 || !good_cands(cands)) return (int)cudaErrorInvalidValue;
  if (n == 0) return 0;
  int rc = allow_smem((const void*)universal_kernel, kUniSmem);
  if (rc) return rc;
  universal_kernel<<<(n + cands - 1) / cands, kGroupThreads, kUniSmem,
                     (cudaStream_t)stream>>>(cache_s, cache_f, cap, ab, op,
                                             spoints, rtol, n, cands, out_s,
                                             out_f, packed);
  return (int)cudaGetLastError();
}
