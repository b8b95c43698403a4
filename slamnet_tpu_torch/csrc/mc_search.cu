// K8: CoreSLAM's Monte-Carlo search scored and reduced to its first minimum
// in one launch.
//
// Replaces no TPU kernel: the JAX package runs the search in XLA
// (slamnet_tpu/ops/score.py::monte_carlo_search).  Added because the plain
// PyTorch version (ops/score.py::best_of_plain: candidate_pixels,
// score_candidates, then the first minimum) is ~45 small operators a
// searched scan, launched one by one from Python: the rotate and snap of a
// [B, N] grid with float64 round trips for cos and sin, the bounds masks,
// two where, the gather, two int32 sums, argmin and two index_select.  The
// kernel computes the same pose and sum bit for bit.
//
// What bounds it on an H100: for coreslam_sim256 (B = 4,001 candidates,
// N = 400 points, a 256-px map) the f32 transform is 8 operations a
// candidate and point, 12.8 M operations, ~0.19 us at 67 TFLOP/s; the
// bytes read once (candidates 48 KB, the 256-KB map, the points) take
// ~0.09 us at 3.35 TB/s.  The 1.6 M snapped reads of the map hit L2 (the
// map is 256 KB of its 50 MB): what costs is their latency and the
// launch's own ~2-3 us.
//
// What the design does about it:
//   * a warp a candidate, its lanes over the points: each lane computes the
//     candidate's transform (the double cos and sin are the same on every
//     lane), then its points' snaps and map reads, independent of one
//     another, through the read-only path (__ldg), so that the reads of a
//     warp overlap;
//   * the points and their valid flags are staged in shared memory once a
//     block (kChunk at a time for a larger scan), so 8 warps read them from
//     global memory once;
//   * each warp reduces its lanes' sums and counts with shuffles; the
//     candidate's key is (effective sum, index) packed in a u64, the sum's
//     sign bit flipped so that unsigned order is signed order: the least
//     key is the first minimum of the effective sums, as torch.argmin takes
//     it.  A block takes the least of its warps' keys and one atomicMin
//     folds it into a u64 slot;
//   * the last block to finish (an atomic ticket after a fence) reads the
//     slot, writes the winner's pose (the candidate's f32 bits) and its
//     effective sum, and re-arms the slot and the ticket: one launch, no
//     memset before it, safe to capture in a CUDA graph.  The slot and
//     ticket are one per device (ops/score.py::_slot): one K8 at a time a
//     device, as one stream runs it.
//
// Every float operation is the plain path's, in its order and rounding:
// px = x * scale + 0.5, c = f32(cos(double(theta))) * scale (sin alike),
// X' = (px + c X) - s Y and Y' = (py + s X) + c Y, each product and sum
// rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn, never fused), then
// C#'s truncation as the saturating float-to-int conversion (torch's
// trunc().to(int32) on the card).  A point counts where 0 <= x, y < size
// and its beam is valid; the sum of the counted map values wraps in int32 as
// the plain path's int32 sum does; a candidate with no point counted scores
// INT32_MAX.  Build without --use_fast_math and with -fmad=false (see
// ops/_build.py).

#include <cuda_runtime.h>

// Mirrored by ops/score.py::_SearchParams (ctypes, passed by value).
struct SearchParams {
  int b;           // candidates
  int n;           // points
  int size;        // the map is size x size pixels
  float scale;     // pixels per meter, as f32
};

namespace {

constexpr int kWarps = 8;               // candidates a block
constexpr int kThreads = kWarps * 32;
constexpr int kChunk = 1024;            // points staged at a time
constexpr int kInt32Max = 0x7fffffff;
constexpr unsigned long long kEmpty = ~0ull;  // the slot between launches
constexpr unsigned kSignBit = 0x80000000u;

__device__ __forceinline__ unsigned long long pack(int eff, int b) {
  return (static_cast<unsigned long long>(static_cast<unsigned>(eff) ^
                                          kSignBit) << 32) |
         static_cast<unsigned>(b);
}

// slot[0]: the least key so far; slot[1]: the blocks done.  out: i32[4],
// the winner's pose as f32 bits, then its effective sum.
__global__ void __launch_bounds__(kThreads)
mc_search_kernel(const float* __restrict__ cands, const int* __restrict__ map,
                 const float* __restrict__ points,
                 const unsigned char* __restrict__ valid,
                 unsigned long long* slot, int* __restrict__ out,
                 SearchParams p) {
  __shared__ float s_x[kChunk], s_y[kChunk];
  __shared__ unsigned char s_ok[kChunk];
  __shared__ unsigned long long s_key[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kWarps + warp;
  const bool live = b < p.b;

  // the candidate's frame (ops/score.py::candidate_pixels)
  float px = 0.0f, py = 0.0f, c = 0.0f, s = 0.0f;
  if (live) {
    px = __fadd_rn(__fmul_rn(cands[3 * b], p.scale), 0.5f);
    py = __fadd_rn(__fmul_rn(cands[3 * b + 1], p.scale), 0.5f);
    const double th = static_cast<double>(cands[3 * b + 2]);
    c = __fmul_rn(static_cast<float>(cos(th)), p.scale);
    s = __fmul_rn(static_cast<float>(sin(th)), p.scale);
  }

  unsigned sum = 0;                      // wraps as an int32 sum does
  int count = 0;
  for (int base = 0; base < p.n; base += kChunk) {
    const int m = min(kChunk, p.n - base);
    __syncthreads();                     // the last chunk is read
    for (int i = threadIdx.x; i < m; i += kThreads) {
      s_x[i] = points[2 * (base + i)];
      s_y[i] = points[2 * (base + i) + 1];
      s_ok[i] = valid[base + i];
    }
    __syncthreads();
    if (!live) continue;
    for (int i = lane; i < m; i += 32) {
      if (s_ok[i] == 0) continue;
      const float X = s_x[i], Y = s_y[i];
      const int x = __float2int_rz(
          __fsub_rn(__fadd_rn(px, __fmul_rn(c, X)), __fmul_rn(s, Y)));
      const int y = __float2int_rz(
          __fadd_rn(__fadd_rn(py, __fmul_rn(s, X)), __fmul_rn(c, Y)));
      if (x >= 0 && x < p.size && y >= 0 && y < p.size) {
        sum += static_cast<unsigned>(__ldg(map + y * p.size + x));
        ++count;
      }
    }
  }
  for (int d = 16; d > 0; d >>= 1) {
    sum += __shfl_xor_sync(0xffffffffu, sum, d);
    count += __shfl_xor_sync(0xffffffffu, count, d);
  }
  if (lane == 0)
    s_key[warp] = live ? pack(count > 0 ? static_cast<int>(sum) : kInt32Max,
                              b)
                       : kEmpty;
  __syncthreads();
  if (threadIdx.x != 0) return;
  unsigned long long key = s_key[0];
  for (int w = 1; w < kWarps; ++w) key = min(key, s_key[w]);
  atomicMin(&slot[0], key);
  __threadfence();                       // the min lands before the ticket
  if (atomicAdd(&slot[1], 1ull) != gridDim.x - 1) return;
  __threadfence();
  // the last block: every block's min is in the slot
  key = atomicExch(&slot[0], kEmpty);
  slot[1] = 0;
  const int best = static_cast<int>(key & 0xffffffffu);
  const unsigned* bits = reinterpret_cast<const unsigned*>(cands) + 3 * best;
  out[0] = static_cast<int>(bits[0]);
  out[1] = static_cast<int>(bits[1]);
  out[2] = static_cast<int>(bits[2]);
  out[3] = static_cast<int>(static_cast<unsigned>(key >> 32) ^ kSignBit);
}

}  // namespace

// The first minimum of the B candidates' effective sums into out (i32[4]:
// the pose's f32 bits, the sum); slot (u64[2]) holds ~0 and 0 between
// launches and is left so.
extern "C" int slamnet_mc_search(const float* cands, const int* map,
                                 const float* points,
                                 const unsigned char* valid,
                                 unsigned long long* slot, int* out,
                                 SearchParams p, cudaStream_t stream) {
  if (p.b < 1 || p.n < 0 || p.size < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (p.b + kWarps - 1) / kWarps;
  mc_search_kernel<<<grid, kThreads, 0, stream>>>(cands, map, points, valid,
                                                  slot, out, p);
  return static_cast<int>(cudaGetLastError());
}
