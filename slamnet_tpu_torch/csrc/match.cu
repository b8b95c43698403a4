// K1, K3, K5 and K6: the whole coarse-to-fine Hector Gauss-Newton match in
// one launch, for one robot (K1, K3), for B robots with one block each (K5,
// the batched K3), or for B robots packed g_pack to a block (K6).  One kernel
// body serves all of them, templated on the precision of the table.
//
// Replaces the TPU kernels
//   K1  pallas_onehot.py make_pallas_match         (body _match_kernel,
//                                   batched=False; prolog prepare_tables)
//   K5  pallas_onehot.py make_pallas_match_batch   (body _match_kernel,
//                                   batched=True, a grid over instances;
//                                   prolog prepare_tables_batch)
//   K6  pallas_onehot.py make_pallas_match_packed  (body _match_kernel_packed:
//                                   G instances stacked on sublanes,
//                                   segment-matmul sums)
//   K3  pallas_gn.py match_pallas  (body _matcher_kernel: the f32 table, a
//                                   per-beam scalar loop of single-element
//                                   VMEM loads)
// all under slamnet_tpu/ops/.  K1/K5/K6 read the table through bf16 rounding
// (matcher_mode "pallas" / "onehot_bf16"); K3 reads the f32 maps as they are
// (matcher_mode "gather" / "onehot_highest", the reference-exact gather
// matcher of models/hector.py:194-259 and models/fleet.py:118-187, which
// K3's TPU version computes without the heading wrap, the empty-scan
// fallback, the clamps, the damping and the stats: all are here).
//
// What bounds it on an H100: latency.  A match is a chain of
// sum(estimate_iterations) dependent Gauss-Newton iterations (15 for the
// 7/4/4 pyramid), each a beam-wide reduction of 11 sums followed by a scalar
// 3x3 solve that the next iteration needs.  The bytes are small: one robot's
// f32 maps of all levels are 840 KB at 400/200/100 px, and an iteration reads
// 4 neighbours for each of 100-400 beams.  One match is one block on one of
// the card's 132 SMs, so a single match (K1) is latency-bound by design; the
// fleet (K5) puts B matches in one launch, B blocks over the SMs, and the
// card fills with independent chains.  So the design shortens one
// iteration (measurements: variants of this kernel as CUDA graphs of 200
// calls on an NVIDIA H100 80GB HBM3 at 700 W, PERF.md section 6):
//   * one instance's match is a group of whole warps, one thread per beam
//     (4 warps for the 100 beams of match_subsample=4, 13 for 400), so each
//     iteration is one pass over the beams with no loop inside a thread.
//     Fewer warps, 2 or 4 beams a thread, were slower (1.83 and 2.49 us an
//     iteration against 1.53); so was spreading one match over a thread
//     block cluster of 2-8 SMs (the cluster barrier and the remote reads of
//     the partials cost more than the spread saved);
//   * a beam's four neighbours are read-only loads (__ldg) issued together,
//     and stay in L1 from one iteration to the next; the sigmoid's
//     reciprocal is the IEEE one's fast path (fastpath.cuh).  nvcc wraps
//     1.0f / x in a range test and a call to its slow path, a branch region
//     a division, and the four neighbours' loads and sigmoids then ran one
//     after another: 1.53 us an iteration, 1.24 without.  The SFU's __expf
//     and __fdividef (with __sincosf) were tried on the bf16 table: one of
//     the fleet's 64 robots then converged elsewhere, its residual 10% from
//     the plain version's (bound 5%);
//   * each warp reduces its 11 sums with a transposed butterfly: each of 4
//     rounds halves the slots a lane holds and doubles the lanes sharing a
//     slot (16 shuffles in all, where 11 separate warp sums took 55); lane
//     2j then holds the warp's sum j and writes it to shared memory;
//   * ONE __syncthreads an iteration: the partials are double-buffered by the
//     parity of a running iteration count, so a warp that runs ahead writes
//     the other buffer, and it cannot come round to this one before every
//     warp has passed the next barrier, i.e. finished reading;
//   * after the barrier every warp of the instance reduces the instance's
//     partials itself (lane (j, h) sums sum j over the warps of parity h, one
//     shuffle joins the halves, 11 shuffles broadcast the totals) and solves
//     the 3x3 system itself.  Every warp reads the same partials in the same
//     fixed order, so every thread holds the same pose bit for bit: no
//     publish through shared memory, no second barrier.  (The first warp
//     alone solving, with a second barrier, measured the same.)
//   * the one-instance launches (K1, K3, K5, the batched K3, K6 up to 512
//     threads) are instantiated under __launch_bounds__(512) and built with
//     -maxrregcount=128 (ops/_build.py): ptxas kept them to 64 registers and
//     spilled otherwise (1.35 us an iteration against 1.24).  Blocks of up
//     to 1024 threads (K6 at g_pack 8, or more than 512 beams) take the
//     1024-thread instantiation and its 64-register cap.  Registers never
//     change a result, so both compute the same bits;
//   * K5: blockIdx.x is the instance.  Each block reads its own pyramid at
//     maps + b*cells (size_t offsets), its own points, valid and hint, and
//     writes out[b, 0:6].  K1 is the launch with batch = 1;
//   * K6: g_pack instances share a block, each on its own warps.  The fixed
//     iteration counts give every instance the same control flow, so the
//     block-wide barriers hold, and each instance reduces over its own warps
//     in K5's order: K6 equals K5 bit for bit (the TPU version's segment
//     matmuls reordered the sums; here nothing is reordered);
//   * the f32 maps are read directly (offset_l + yi*w + xi).  The bf16
//     instantiation rounds each neighbour to bf16 on the fly with
//     __float2bfloat16_rn, which reproduces prepare_tables' bf16 table
//     (round to nearest even) value for value, so no per-match table copy
//     is made; the f32 instantiation (K3) takes the value as it is.  The TPU
//     kernels' one-hot matmuls, 128-lane padding, y+1 twin table, beam
//     padding and K3's scalar loads worked around the TPU's missing vector
//     gather and are not carried over;
//   * the empty-scan rule is a flag, as JAX decides it: the single robot's
//     XLA modes test the full scan (hector.py:195,254); K1
//     (pallas_onehot.py:197) and the fleet in every mode (fleet.py:67-71
//     subsamples valid before :119) test the subsampled matcher beams.
//     Under the full-scan rule, valid beams that all fall between the
//     subsampled ones give the GN estimate: the hint through x*scale/scale
//     with its heading wrapped.
//   * the early exit (early_exit_tol > 0, one instance a block: K1 and K3)
//     is JAX's per-level rule (models/hector.py:227-244): a level stops once
//     an iteration moved the pixel-frame pose by no more than the tolerance,
//     moved2 = dx*dx + dy*dy + dth*dth summed in that order on the
//     difference of the updated and the previous pose.  Every thread holds
//     the same pose after the solve, so the test is a uniform branch and the
//     whole block leaves the level together.  The break skips the loop's
//     parity flip; it is flipped on the exit path too, or the next level's
//     first iteration would write the partials buffer that other warps may
//     still be reading.  The exit is a template parameter: with the
//     tolerance at 0 the kernel is the fixed-iteration one, unchanged.
//   * the fleet's early exit (K5 and the batched K3 with early_exit_tol >
//     0) is JAX's batch-wide rule (models/fleet.py:154-172): a level stops
//     after the first iteration in which NO instance moved by more than the
//     tolerance (max_b moved2_b <= tol2; a NaN anywhere stops it too, as
//     jnp.max propagates it), and every instance's pose and stats are those
//     after that shared count li.  One block cannot wait for the others: a
//     cooperative grid.sync would cap B at the blocks the card holds at once
//     (132 at 512 threads and 128 registers), a limit JAX does not have.  So
//     it is one launch a level plus a finishing one.  Each level's launch
//     runs all of the level's iterations in every block, keeps the state
//     after each (pose in the level's pixel frame, fails, residual sum,
//     in-map count: slot 0 the level's start, slot i+1 after iteration i)
//     in a device buffer, and ORs into one 32-bit word a level the
//     iterations in which its instance moved more than the tolerance (bits
//     0-15) or moved by NaN (bits 16-31).  The next level's launch, and the
//     finishing launch after the finest level, read that word, take li, and
//     start from (or write out) each instance's slot li.  Each launch starts
//     its partials' parity afresh, and the iterations past li are computed
//     and thrown away: the answers are JAX's for any B, at the cost of the
//     fixed count's arithmetic.  A per-iteration relaunch (15 launches
//     reading a device flag) would skip that arithmetic but pay a launch
//     for each iteration, each longer than an iteration (PERF.md section 6).
//
// Semantics (pallas_onehot.py:69-212): cells truncate toward zero and clip to
// [0, w-2]; a beam counts when it is valid and its map point lies in
// [0, w-2]^2; sigmoid is 1/(1+expf(-x)); the rotation step is clamped to
// +/-deriv_clamp; the xy clamp and the damping apply only when > 0; a solve
// fails when H00==0 || H11==0 || det==0 || !isfinite(det), and the step is
// then zero; the heading wraps to (-pi, pi] by floored modulo between levels;
// an instance with no valid beam (the matcher's, or with empty_full_scan the
// scan's) returns its hint.  The output is
// f32[7] per instance: x, y, theta (world), solve failures, the residual
// sum and in-bounds beam count of the last iteration run at the finest
// level, and the GN iterations run over all levels.
//
// Build without --use_fast_math (sincosf, expf and the division stay
// IEEE-accurate) and with -fmad=false (see ops/_build.py): allowing FMAs
// here took 4% off an iteration (1.469 us against 1.531, measured before the
// reciprocal's fast path), too little for a second rounding regime beside
// the plain version's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "fastpath.cuh"

constexpr int kMatchMaxLevels = 4;

// Mirrored by ops/match.py::_MatchParams (ctypes, passed by value).
struct MatchParams {
  int num_levels;
  int n;          // beams the matcher uses per instance (after match_subsample)
  int stride;     // match_subsample: beam i is point i*stride
  int n_points;   // points per instance (before subsampling)
  int cells;      // map cells per instance (its whole pyramid)
  int g_pack;     // instances per block (1 for K1 and K5)
  int batch;      // instances (1 for K1 and K3)
  int table_f32;  // 1: read the f32 table as it is (K3); 0: through bf16
  int empty_full_scan;  // 1: the hint only when no beam of the whole scan is
                        // valid (a single robot's XLA modes); 0: when no
                        // matcher beam is (K1, and every fleet mode)
  int width[kMatchMaxLevels];
  int offset[kMatchMaxLevels];
  int iters[kMatchMaxLevels];
  float scale[kMatchMaxLevels];   // map pixels per meter
  float deriv_clamp;
  float xy_clamp;
  float damping;
  float tol2;     // early_exit_tol squared in f32; 0: fixed iterations
};

// The fleet exit's device state (slamnet_match_batch_exit), carved from one
// f32 workspace of exit_work_floats(p) floats: the words, then any, then
// state.
struct BatchExit {
  unsigned* words;  // [kMatchMaxLevels]: a level's moved bits (see above)
  float* any;       // [batch]: 1 when the instance has a valid matcher beam
  float* state;     // [num_levels][batch][slots][kState]
  int level;        // the level this launch runs
  int slots;        // max per-level iterations + 1
};

namespace {

constexpr int kOut = 7;           // floats an instance writes
constexpr int kState = 6;         // ex, ey, th, fails, resid, n_in
constexpr int kExitMaxIters = 16; // iterations a level the exit words hold
enum ExitMode { kFixed = 0, kBlockExit = 1, kBatchExit = 2 };
constexpr int kSums = 11;          // dTr[3], H upper triangle[6], resid, n_in
constexpr int kSlots = 16;         // kSums padded to the butterfly's 2^4
constexpr int kBeamsPerThread = 4;
constexpr int kMaxPack = 8;
constexpr int kSmallBlock = 512;   // the one-instance launches' bound
constexpr unsigned kFull = 0xffffffffu;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

// A table entry as the matcher reads it: through bf16 rounding (K1, K5, K6)
// or as it is (K3), then the occupancy probability 1 / (1 + e^-v).  The
// reciprocal is the IEEE one's fast path (fastpath.cuh), which agrees with
// the division while 1 + e^-v <= 2^126, i.e. for every map value above
// -87.3.  Below, it gives 0 where the division gives a subnormal under
// 1.2e-38, and below -88.72 e^-v overflows to +inf, whose fast-path
// reciprocal would be NaN: the operand is clamped to 2^127, whose
// reciprocal is 0, as 1 / inf is.  Nothing bounds a free cell's log-odds
// from below, so long runs reach that range.  (A NaN map value, never
// written by the map updates, gives 0 here and NaN in the plain version.)
template <bool kF32Table>
__device__ __forceinline__ float prob(float v) {
  const float t = kF32Table ? v : __bfloat162float(__float2bfloat16_rn(v));
  return recip_fast(fminf(1.0f + expf(-t), 0x1p127f));
}

// jnp.clip semantics: a NaN stays NaN.
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// jnp.mod semantics: fmod, moved to the sign of the divisor.
__device__ __forceinline__ float floor_mod(float x, float y) {
  float r = fmodf(x, y);
  if (r != 0.0f && ((r < 0.0f) != (y < 0.0f))) r += y;
  return r;
}

// Heading wrap to (-pi, pi] (MathEx.NormalizeAngle) and map px -> world, as
// a level ends.
__device__ __forceinline__ void leave_level(float ex, float ey, float th,
                                            float scale, float& px, float& py,
                                            float& th_out) {
  const float wrapped = floor_mod(floor_mod(th, kTwoPi) + kTwoPi, kTwoPi);
  th_out = wrapped > kPi ? wrapped - kTwoPi : wrapped;
  px = ex / scale;
  py = ey / scale;
}

// The batch-wide count of a level's iterations from its exit word: the
// first iteration after which no instance moved more than the tolerance (or
// one moved by NaN), else all n.
__device__ __forceinline__ int shared_count(unsigned word, int n) {
  for (int i = 0; i < n; ++i)
    if (!((word >> i) & 1u) || ((word >> (16 + i)) & 1u)) return i + 1;
  return n;
}

// One butterfly round over the low 2*h slots: the lanes with bit `o` set
// keep the upper half, the others the lower, and each adds its partner's.
template <int h>
__device__ __forceinline__ void fold(float (&a)[kSlots], int lane, int o) {
  const bool up = (lane & o) != 0;
#pragma unroll
  for (int i = 0; i < h; ++i) {
    const float send = up ? a[i] : a[i + h];
    const float keep = up ? a[i + h] : a[i];
    a[i] = keep + __shfl_xor_sync(kFull, send, o);
  }
}

template <bool kF32Table, int kExit, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads)
match_kernel(const float* __restrict__ maps, const float* __restrict__ points,
             const unsigned char* __restrict__ valid,
             const float* __restrict__ pose0, float* __restrict__ out,
             MatchParams p, BatchExit x) {
  __shared__ float s_part[2][32][kSums];   // [iteration parity][warp][sum]
  __shared__ int s_any[32];

  // this thread's instance g of the block's g_pack, and its place in it
  const int lthreads = blockDim.x / p.g_pack;     // whole warps
  const int wpi = lthreads >> 5;                  // warps per instance
  const int g = threadIdx.x / lthreads;
  const int tid = threadIdx.x - g * lthreads;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t inst = static_cast<size_t>(blockIdx.x) * p.g_pack + g;

  maps += inst * p.cells;
  points += inst * p.n_points * 2;
  valid += inst * p.n_points;
  pose0 += inst * 3;
  out += inst * kOut;

  float bx[kBeamsPerThread], by[kBeamsPerThread];
  bool bv[kBeamsPerThread];
  bool any_local = false;
#pragma unroll
  for (int k = 0; k < kBeamsPerThread; ++k) {
    const int b = tid + k * lthreads;
    const bool in = b < p.n;
    const int src = in ? b * p.stride : 0;
    bx[k] = in ? points[2 * src] : 0.0f;
    by[k] = in ? points[2 * src + 1] : 0.0f;
    bv[k] = in && valid[src] != 0;
    any_local |= bv[k];
  }
  if (p.empty_full_scan) {
    any_local = false;
    for (int i = tid; i < p.n_points; i += lthreads) any_local |= valid[i] != 0;
  }
  const bool any_warp = __any_sync(kFull, any_local);
  if (lane == 0) s_any[warp] = any_warp;

  // every thread of the instance carries the same pose and stats
  float px = pose0[0], py = pose0[1], th = pose0[2];
  float fails = 0.0f, resid = 0.0f, n_in = 0.0f, n_iter = 0.0f;
  int parity = 0;
  const float* __restrict__ part = &s_part[0][g * wpi][0];
  const int j_sum = lane >> 1;       // the sum this lane reduces across warps
  // the batch exit runs one level a launch, from the coarser level's state
  // after that level's shared count of iterations
  const int top = kExit == kBatchExit ? x.level : p.num_levels - 1;
  const int bottom = kExit == kBatchExit ? x.level : 0;
  float* slot = nullptr;
  unsigned moved_bits = 0u;
  if (kExit == kBatchExit) {
    slot = x.state + ((static_cast<size_t>(x.level) * p.batch + inst) *
                      x.slots) * kState;
    if (x.level + 1 < p.num_levels) {
      const int lc = x.level + 1;
      const float* s = x.state +
          ((static_cast<size_t>(lc) * p.batch + inst) * x.slots +
           shared_count(x.words[lc], p.iters[lc])) * kState;
      leave_level(s[0], s[1], s[2], p.scale[lc], px, py, th);
      fails = s[3];
      resid = s[4];
      n_in = s[5];
    }
  }

  for (int level = top; level >= bottom; --level) {
    const int w = p.width[level];
    const float wlim = static_cast<float>(w - 2);
    const float scale = p.scale[level];
    const float* __restrict__ tab = maps + p.offset[level];
    float ex = px * scale;
    float ey = py * scale;

    const int iters = p.iters[level];
    if (kExit == kBatchExit && tid == 0) {
      slot[0] = ex; slot[1] = ey; slot[2] = th;
      slot[3] = fails; slot[4] = resid; slot[5] = n_in;
    }
    for (int it = 0; it < iters; ++it, parity ^= 1) {
      float sn, cs;
      sincosf(th, &sn, &cs);
      const float sr = sn * scale;
      const float cr = cs * scale;
      float a[kSlots];
#pragma unroll
      for (int j = 0; j < kSlots; ++j) a[j] = 0.0f;

#pragma unroll
      for (int k = 0; k < kBeamsPerThread; ++k) {
        if (tid + k * lthreads >= p.n) break;
        const float X = bx[k], Y = by[k];
        const float mx = cr * X - sr * Y + ex;
        const float my = sr * X + cr * Y + ey;
        const bool ok = bv[k] && mx >= 0.0f && mx <= wlim && my >= 0.0f &&
                        my <= wlim;
        // float -> int truncates toward zero (and saturates, NaN -> 0)
        const int xi = min(max(static_cast<int>(mx), 0), w - 2);
        const int yi = min(max(static_cast<int>(my), 0), w - 2);
        const float* c = tab + yi * w + xi;
        const float t0 = __ldg(c), t1 = __ldg(c + 1);
        const float t2 = __ldg(c + w), t3 = __ldg(c + w + 1);
        const float v0 = prob<kF32Table>(t0);
        const float v1 = prob<kF32Table>(t1);
        const float v2 = prob<kF32Table>(t2);
        const float v3 = prob<kF32Table>(t3);
        const float fx = mx - static_cast<float>(xi);
        const float fy = my - static_cast<float>(yi);
        const float xf = 1.0f - fx;
        const float yf = 1.0f - fy;
        const float val = (v0 * xf + v1 * fx) * yf + (v2 * xf + v3 * fx) * fy;
        const float gx = ok ? -((v0 - v1) * xf + (v2 - v3) * fx) : 0.0f;
        const float gy = ok ? -((v0 - v2) * yf + (v1 - v3) * fy) : 0.0f;
        const float fun = ok ? 1.0f - val : 0.0f;
        const float rot = (-sr * X - cr * Y) * gx + (cr * X - sr * Y) * gy;
        a[0] += gx * fun;
        a[1] += gy * fun;
        a[2] += rot * fun;
        a[3] += gx * gx;
        a[4] += gx * gy;
        a[5] += gx * rot;
        a[6] += gy * gy;
        a[7] += gy * rot;
        a[8] += rot * rot;
        a[9] += fun * fun;
        a[10] += ok ? 1.0f : 0.0f;
      }

      // the warp's 11 sums: after the rounds over lane bits 4, 3, 2, 1,
      // lanes 2j and 2j+1 hold halves of slot j; bit 0 joins them
      fold<8>(a, lane, 16);
      fold<4>(a, lane, 8);
      fold<2>(a, lane, 4);
      fold<1>(a, lane, 2);
      a[0] += __shfl_xor_sync(kFull, a[0], 1);
      if ((lane & 1) == 0 && j_sum < kSums) s_part[parity][warp][j_sum] = a[0];
      __syncthreads();

      // the instance's sums, the same order in every warp: lane (j, h) adds
      // sum j of warps h, h+2, ...; the halves join, then every lane takes
      // every total
      const float* pp = part + parity * (32 * kSums);
      float t = 0.0f;
      if (j_sum < kSums)
        for (int wv = lane & 1; wv < wpi; wv += 2) t += pp[wv * kSums + j_sum];
      t += __shfl_xor_sync(kFull, t, 1);
      float r[kSums];
#pragma unroll
      for (int j = 0; j < kSums; ++j) r[j] = __shfl_sync(kFull, t, 2 * j);

      const float d0 = r[0], d1 = r[1], d2 = r[2];
      float H00 = r[3], H01 = r[4], H02 = r[5];
      float H11 = r[6], H12 = r[7], H22 = r[8];
      if (p.damping > 0.0f) {
        H00 = H00 * (1.0f + p.damping);
        H11 = H11 * (1.0f + p.damping);
        H22 = H22 * (1.0f + p.damping);
      }
      const float a0 = H11 * H22 - H12 * H12;
      const float a1 = H02 * H12 - H01 * H22;
      const float a2 = H01 * H12 - H02 * H11;
      const float det = H00 * a0 + H01 * a1 + H02 * a2;
      const float b1 = H00 * H22 - H02 * H02;
      const float b2 = H01 * H02 - H00 * H12;
      const float c2 = H00 * H11 - H01 * H01;
      const bool ok = H00 != 0.0f && H11 != 0.0f && det != 0.0f &&
                      isfinite(det);
      const float inv = ok ? 1.0f / det : 0.0f;
      float s0 = (a0 * d0 + a1 * d1 + a2 * d2) * inv;
      float s1 = (a1 * d0 + b1 * d1 + b2 * d2) * inv;
      if (p.xy_clamp > 0.0f) {
        s0 = clip(s0, -p.xy_clamp, p.xy_clamp);
        s1 = clip(s1, -p.xy_clamp, p.xy_clamp);
      }
      const float s2 = clip((a2 * d0 + b2 * d1 + c2 * d2) * inv,
                            -p.deriv_clamp, p.deriv_clamp);
      const float ex0 = ex, ey0 = ey, th0 = th;
      ex += s0;
      ey += s1;
      th += s2;
      fails += ok ? 0.0f : 1.0f;
      resid = r[9];
      n_in = r[10];
      n_iter += 1.0f;
      if (kExit == kBlockExit) {
        const float dx = ex - ex0, dy = ey - ey0, dt = th - th0;
        if (!(dx * dx + dy * dy + dt * dt > p.tol2)) {
          parity ^= 1;   // the flip the skipped loop increment would make
          break;
        }
      }
      if (kExit == kBatchExit) {
        const float dx = ex - ex0, dy = ey - ey0, dt = th - th0;
        const float moved2 = dx * dx + dy * dy + dt * dt;
        moved_bits |= (moved2 > p.tol2 ? 1u : 0u) << it;
        moved_bits |= (isnan(moved2) ? 1u : 0u) << (16 + it);
        if (tid == 0) {
          float* s = slot + (it + 1) * kState;
          s[0] = ex; s[1] = ey; s[2] = th;
          s[3] = fails; s[4] = resid; s[5] = n_in;
        }
      }
    }

    leave_level(ex, ey, th, scale, px, py, th);
  }

  __syncthreads();   // s_any, even when no level iterates
  if (kExit == kBatchExit) {
    // the finishing launch writes out; this one leaves its moved bits and,
    // at the finest level, whether the instance has a valid beam
    if (tid == 0) {
      if (moved_bits) atomicOr(x.words + x.level, moved_bits);
      if (x.level == 0) {
        bool any_valid = false;
        for (int wv = 0; wv < wpi; ++wv) any_valid |= s_any[g * wpi + wv] != 0;
        x.any[inst] = any_valid ? 1.0f : 0.0f;
      }
    }
    return;
  }
  if (tid == 0) {
    bool any_valid = false;
    for (int wv = 0; wv < wpi; ++wv) any_valid |= s_any[g * wpi + wv] != 0;
    // empty scan: the hint comes back (ScanMatcher.cs:82-83)
    out[0] = any_valid ? px : pose0[0];
    out[1] = any_valid ? py : pose0[1];
    out[2] = any_valid ? th : pose0[2];
    out[3] = fails;
    out[4] = resid;
    out[5] = n_in;
    out[6] = n_iter;
  }
}

template <bool kF32Table, int kExit>
cudaError_t launch(int blocks, int threads, const float* maps,
                   const float* points, const unsigned char* valid,
                   const float* pose0, float* out, const MatchParams& p,
                   const BatchExit& x, cudaStream_t stream) {
  if (threads <= kSmallBlock)
    match_kernel<kF32Table, kExit, kSmallBlock>
        <<<blocks, threads, 0, stream>>>(maps, points, valid, pose0, out, p,
                                         x);
  else
    match_kernel<kF32Table, kExit, 1024><<<blocks, threads, 0, stream>>>(
        maps, points, valid, pose0, out, p, x);
  return cudaGetLastError();
}

template <bool kF32Table>
cudaError_t launch_table(int mode, int blocks, int threads, const float* maps,
                         const float* points, const unsigned char* valid,
                         const float* pose0, float* out, const MatchParams& p,
                         const BatchExit& x, cudaStream_t stream) {
  switch (mode) {
    case kBlockExit:
      return launch<kF32Table, kBlockExit>(blocks, threads, maps, points,
                                           valid, pose0, out, p, x, stream);
    case kBatchExit:
      return launch<kF32Table, kBatchExit>(blocks, threads, maps, points,
                                           valid, pose0, out, p, x, stream);
    default:
      return launch<kF32Table, kFixed>(blocks, threads, maps, points, valid,
                                       pose0, out, p, x, stream);
  }
}

int match_threads(const MatchParams& p) {
  int threads = ((p.n + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  if (threads > 1024) threads = 1024;
  return threads;
}

// The fleet exit's last launch: one thread an instance takes the finest
// level's state after its shared count, wraps the heading, and writes
// out[b, 0:7] as the single launch would (the hint for an instance with no
// valid matcher beam; out[:, 6] the shared counts summed over the levels).
__global__ void exit_finish_kernel(const float* __restrict__ pose0,
                                   float* __restrict__ out, MatchParams p,
                                   BatchExit x) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= p.batch) return;
  float n_iter = 0.0f;
  for (int l = 0; l < p.num_levels; ++l)
    n_iter += static_cast<float>(shared_count(x.words[l], p.iters[l]));
  const float* s = x.state + (static_cast<size_t>(b) * x.slots +
                              shared_count(x.words[0], p.iters[0])) * kState;
  float px, py, th;
  leave_level(s[0], s[1], s[2], p.scale[0], px, py, th);
  const bool any_valid = x.any[b] != 0.0f;
  float* o = out + static_cast<size_t>(b) * kOut;
  o[0] = any_valid ? px : pose0[3 * b];
  o[1] = any_valid ? py : pose0[3 * b + 1];
  o[2] = any_valid ? th : pose0[3 * b + 2];
  o[3] = s[3];
  o[4] = s[4];
  o[5] = s[5];
  o[6] = n_iter;
}

int exit_slots(const MatchParams& p) {
  int slots = 0;
  for (int l = 0; l < p.num_levels; ++l)
    slots = p.iters[l] > slots ? p.iters[l] : slots;
  return slots + 1;
}

}  // namespace

// One launch of batch / g_pack blocks, each of g_pack instances' threads;
// the f32 instantiation (K3) when p.table_f32, else the bf16 one; the
// single robot's early exit when p.tol2 > 0 (one instance only: a fleet's
// exit is the batch-wide rule of slamnet_match_batch_exit); the 512-thread
// bound when the block allows it, else the 1024-thread one.
extern "C" int slamnet_match(const float* maps, const float* points,
                             const unsigned char* valid, const float* pose0,
                             float* out, MatchParams p, cudaStream_t stream) {
  const int threads = match_threads(p);
  if (p.g_pack < 1 || p.g_pack > kMaxPack || p.batch < 1 ||
      p.batch % p.g_pack != 0 || threads * p.g_pack > 1024 ||
      (p.tol2 > 0.0f && p.batch != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = p.batch / p.g_pack;
  const int mode = p.tol2 > 0.0f ? kBlockExit : kFixed;
  const BatchExit none{};
  const cudaError_t err =
      p.table_f32 ? launch_table<true>(mode, blocks, threads * p.g_pack, maps,
                                       points, valid, pose0, out, p, none,
                                       stream)
                  : launch_table<false>(mode, blocks, threads * p.g_pack,
                                        maps, points, valid, pose0, out, p,
                                        none, stream);
  return static_cast<int>(err);
}

// Floats of the fleet exit's workspace: the level words, the any flags and
// the per-level, per-instance, per-iteration state.
extern "C" long long slamnet_match_exit_work(MatchParams p) {
  return kMatchMaxLevels + static_cast<long long>(p.batch) +
         static_cast<long long>(p.num_levels) * p.batch * exit_slots(p) *
             kState;
}

// The fleet's batch-wide early exit (K5 and the batched K3 with p.tol2 > 0,
// one instance a block): the level words cleared, one launch a level from
// the coarsest, then the finishing launch.  `work` holds
// slamnet_match_exit_work(p) floats.
extern "C" int slamnet_match_batch_exit(const float* maps, const float* points,
                                        const unsigned char* valid,
                                        const float* pose0, float* out,
                                        float* work, MatchParams p,
                                        cudaStream_t stream) {
  const int threads = match_threads(p);
  bool ok = p.g_pack == 1 && p.batch >= 1 && p.tol2 > 0.0f &&
            p.num_levels >= 1 && p.num_levels <= kMatchMaxLevels;
  for (int l = 0; ok && l < p.num_levels; ++l)
    ok = p.iters[l] >= 0 && p.iters[l] <= kExitMaxIters;
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  BatchExit x;
  x.words = reinterpret_cast<unsigned*>(work);
  x.any = work + kMatchMaxLevels;
  x.state = x.any + p.batch;
  x.slots = exit_slots(p);
  cudaError_t err = cudaMemsetAsync(x.words, 0, kMatchMaxLevels * sizeof(unsigned),
                                    stream);
  for (int l = p.num_levels - 1; err == cudaSuccess && l >= 0; --l) {
    x.level = l;
    err = p.table_f32
              ? launch_table<true>(kBatchExit, p.batch, threads, maps, points,
                                   valid, pose0, out, p, x, stream)
              : launch_table<false>(kBatchExit, p.batch, threads, maps, points,
                                    valid, pose0, out, p, x, stream);
  }
  if (err == cudaSuccess) {
    exit_finish_kernel<<<(p.batch + 127) / 128, 128, 0, stream>>>(pose0, out,
                                                                   p, x);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}
