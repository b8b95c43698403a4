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
// card fills with independent chains.
//
// What the design does about it:
//   * one instance's match is a group of whole warps, one thread per beam
//     (4 warps for the 100 beams of match_subsample=4, 13 for 400), so each
//     iteration is one pass over the beams with no loop inside a thread;
//   * the 11 sums go through warp shuffles, then across the instance's warps
//     in shared memory; the instance's thread 0 solves and publishes the pose
//     through shared memory, and one __syncthreads() ends the iteration — two
//     barriers per iteration, every level in the same launch;
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
// Build without --use_fast_math (sinf, cosf, expf and the division stay
// IEEE-accurate) and with -fmad=false (see ops/_build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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
constexpr int kBeamsPerThread = 4;
constexpr int kMaxPack = 8;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kTwoPi = 6.28318530717958647692f;

// A table entry as the matcher reads it: through bf16 rounding (K1, K5, K6)
// or as it is (K3), then the occupancy probability 1 / (1 + e^-v).
template <bool kF32Table>
__device__ __forceinline__ float prob(float v) {
  const float t = kF32Table ? v : __bfloat162float(__float2bfloat16_rn(v));
  return 1.0f / (1.0f + expf(-t));
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

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

// 1024 threads (K6 at g_pack 8, or K1 above 992 beams) may run only when a
// thread keeps to 64 registers: the bound makes the compiler keep to them.
template <bool kF32Table>
__global__ void __launch_bounds__(1024)
match_kernel(const float* __restrict__ maps, const float* __restrict__ points,
             const unsigned char* __restrict__ valid,
             const float* __restrict__ pose0, float* __restrict__ out,
             MatchParams p) {
  __shared__ float s_part[32][kSums];
  __shared__ float s_pose[kMaxPack][3];
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
  const bool any_warp = __any_sync(0xffffffffu, any_local);
  if (lane == 0) s_any[warp] = any_warp;
  __syncthreads();

  float px = pose0[0], py = pose0[1], th = pose0[2];
  float fails = 0.0f, resid = 0.0f, n_in = 0.0f;   // kept by tid 0

  for (int level = p.num_levels - 1; level >= 0; --level) {
    const int w = p.width[level];
    const float wlim = static_cast<float>(w - 2);
    const float scale = p.scale[level];
    const float* __restrict__ tab = maps + p.offset[level];
    float ex = px * scale;
    float ey = py * scale;

    for (int it = 0; it < p.iters[level]; ++it) {
      const float sr = sinf(th) * scale;
      const float cr = cosf(th) * scale;
      float acc[kSums];
#pragma unroll
      for (int j = 0; j < kSums; ++j) acc[j] = 0.0f;

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
        const float v0 = prob<kF32Table>(c[0]);
        const float v1 = prob<kF32Table>(c[1]);
        const float v2 = prob<kF32Table>(c[w]);
        const float v3 = prob<kF32Table>(c[w + 1]);
        const float fx = mx - static_cast<float>(xi);
        const float fy = my - static_cast<float>(yi);
        const float xf = 1.0f - fx;
        const float yf = 1.0f - fy;
        const float val = (v0 * xf + v1 * fx) * yf + (v2 * xf + v3 * fx) * fy;
        const float gx = ok ? -((v0 - v1) * xf + (v2 - v3) * fx) : 0.0f;
        const float gy = ok ? -((v0 - v2) * yf + (v1 - v3) * fy) : 0.0f;
        const float fun = ok ? 1.0f - val : 0.0f;
        const float rot = (-sr * X - cr * Y) * gx + (cr * X - sr * Y) * gy;
        acc[0] += gx * fun;
        acc[1] += gy * fun;
        acc[2] += rot * fun;
        acc[3] += gx * gx;
        acc[4] += gx * gy;
        acc[5] += gx * rot;
        acc[6] += gy * gy;
        acc[7] += gy * rot;
        acc[8] += rot * rot;
        acc[9] += fun * fun;
        acc[10] += ok ? 1.0f : 0.0f;
      }

#pragma unroll
      for (int j = 0; j < kSums; ++j) {
        const float v = warp_sum(acc[j]);
        if (lane == 0) s_part[warp][j] = v;
      }
      __syncthreads();

      if (tid < 32) {   // the instance's first warp sums over its warps
        float r[kSums];
#pragma unroll
        for (int j = 0; j < kSums; ++j)
          r[j] = warp_sum(lane < wpi ? s_part[g * wpi + lane][j] : 0.0f);
        if (tid == 0) {
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
          s_pose[g][0] = ex + s0;
          s_pose[g][1] = ey + s1;
          s_pose[g][2] = th + s2;
          fails += ok ? 0.0f : 1.0f;
          resid = r[9];
          n_in = r[10];
        }
      }
      __syncthreads();
      ex = s_pose[g][0];
      ey = s_pose[g][1];
      th = s_pose[g][2];
    }

    // heading wrap to (-pi, pi] (MathEx.NormalizeAngle), map px -> world
    const float a = floor_mod(floor_mod(th, kTwoPi) + kTwoPi, kTwoPi);
    th = a > kPi ? a - kTwoPi : a;
    px = ex / scale;
    py = ey / scale;
  }

  if (tid == 0) {
    bool any_valid = false;
    for (int w = 0; w < wpi; ++w) any_valid |= s_any[g * wpi + w] != 0;
    // empty scan: the hint comes back (ScanMatcher.cs:82-83)
    out[0] = any_valid ? px : pose0[0];
    out[1] = any_valid ? py : pose0[1];
    out[2] = any_valid ? th : pose0[2];
    out[3] = fails;
    out[4] = resid;
    out[5] = n_in;
  }
}

}  // namespace

// One launch of batch / g_pack blocks, each of g_pack instances' threads;
// the f32 instantiation (K3) when p.table_f32, else the bf16 one.
extern "C" int slamnet_match(const float* maps, const float* points,
                             const unsigned char* valid, const float* pose0,
                             float* out, MatchParams p, cudaStream_t stream) {
  int threads = ((p.n + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  if (threads > 1024) threads = 1024;
  if (p.g_pack < 1 || p.g_pack > kMaxPack || p.batch < 1 ||
      p.batch % p.g_pack != 0 || threads * p.g_pack > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(p.batch / p.g_pack), block(threads * p.g_pack);
  if (p.table_f32)
    match_kernel<true><<<grid, block, 0, stream>>>(maps, points, valid, pose0,
                                                   out, p);
  else
    match_kernel<false><<<grid, block, 0, stream>>>(maps, points, valid,
                                                    pose0, out, p);
  return static_cast<int>(cudaGetLastError());
}
