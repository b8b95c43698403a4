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
//
// Semantics (pallas_onehot.py:69-212): cells truncate toward zero and clip to
// [0, w-2]; a beam counts when it is valid and its map point lies in
// [0, w-2]^2; sigmoid is 1/(1+expf(-x)); the rotation step is clamped to
// +/-deriv_clamp; the xy clamp and the damping apply only when > 0; a solve
// fails when H00==0 || H11==0 || det==0 || !isfinite(det), and the step is
// then zero; the heading wraps to (-pi, pi] by floored modulo between levels;
// an instance with no valid beam (the matcher's, or with empty_full_scan the
// scan's) returns its hint.  The output is
// f32[6] per instance: x, y, theta (world), solve failures, and the residual
// sum and in-bounds beam count of the last iteration of the finest level.
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
};

namespace {

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

template <bool kF32Table, int kMaxThreads>
__global__ void __launch_bounds__(kMaxThreads)
match_kernel(const float* __restrict__ maps, const float* __restrict__ points,
             const unsigned char* __restrict__ valid,
             const float* __restrict__ pose0, float* __restrict__ out,
             MatchParams p) {
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
  out += inst * 6;

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
  float fails = 0.0f, resid = 0.0f, n_in = 0.0f;
  int parity = 0;
  const float* __restrict__ part = &s_part[0][g * wpi][0];
  const int j_sum = lane >> 1;       // the sum this lane reduces across warps

  for (int level = p.num_levels - 1; level >= 0; --level) {
    const int w = p.width[level];
    const float wlim = static_cast<float>(w - 2);
    const float scale = p.scale[level];
    const float* __restrict__ tab = maps + p.offset[level];
    float ex = px * scale;
    float ey = py * scale;

    const int iters = p.iters[level];
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
      ex += s0;
      ey += s1;
      th += s2;
      fails += ok ? 0.0f : 1.0f;
      resid = r[9];
      n_in = r[10];
    }

    // heading wrap to (-pi, pi] (MathEx.NormalizeAngle), map px -> world
    const float wrapped = floor_mod(floor_mod(th, kTwoPi) + kTwoPi, kTwoPi);
    th = wrapped > kPi ? wrapped - kTwoPi : wrapped;
    px = ex / scale;
    py = ey / scale;
  }

  __syncthreads();   // s_any, even when no level iterates
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
  }
}

template <bool kF32Table>
cudaError_t launch(int blocks, int threads, const float* maps,
                   const float* points, const unsigned char* valid,
                   const float* pose0, float* out, const MatchParams& p,
                   cudaStream_t stream) {
  if (threads <= kSmallBlock)
    match_kernel<kF32Table, kSmallBlock><<<blocks, threads, 0, stream>>>(
        maps, points, valid, pose0, out, p);
  else
    match_kernel<kF32Table, 1024><<<blocks, threads, 0, stream>>>(
        maps, points, valid, pose0, out, p);
  return cudaGetLastError();
}

}  // namespace

// One launch of batch / g_pack blocks, each of g_pack instances' threads;
// the f32 instantiation (K3) when p.table_f32, else the bf16 one; the
// 512-thread bound when the block allows it, else the 1024-thread one.
extern "C" int slamnet_match(const float* maps, const float* points,
                             const unsigned char* valid, const float* pose0,
                             float* out, MatchParams p, cudaStream_t stream) {
  int threads = ((p.n + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  if (threads > 1024) threads = 1024;
  if (p.g_pack < 1 || p.g_pack > kMaxPack || p.batch < 1 ||
      p.batch % p.g_pack != 0 || threads * p.g_pack > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = p.batch / p.g_pack;
  const cudaError_t err =
      p.table_f32 ? launch<true>(blocks, threads * p.g_pack, maps, points,
                                 valid, pose0, out, p, stream)
                  : launch<false>(blocks, threads * p.g_pack, maps, points,
                                  valid, pose0, out, p, stream);
  return static_cast<int>(err);
}
