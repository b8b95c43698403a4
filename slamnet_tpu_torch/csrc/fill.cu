// K2: the dense polar occupancy fill of every pyramid level of one robot or
// of a fleet, one launch a scan or batch-scan.
//
// Replaces the TPU kernel slamnet_tpu/ops/pallas_fill.py::polar_fill_pallas
// (body _fill_kernel) together with the beam-side prolog of its wrapper
// update_occupancy_dense_pallas; it computes what
// slamnet_tpu/ops/logodds.py::update_occupancy_dense computes for each level,
// for every instance whose device flag fire[b] is set (the fleet's
// scan-over-instances lax.cond, slamnet_tpu/models/fleet.py:244-266, and the
// single robot's lax.cond at models/hector.py:324, which is the batch = 1
// case).
//
// What bounds it on an H100: the bytes of the firing instances' maps.  Every
// cell of every level of a firing instance (210,000 at 400/200/100 px) is
// read and written at most once: 840 KB of f32 each way.  A fleet fires ~1
// in 18 instances a batch-scan, and the others must cost nothing.  A cell's
// free test is a sqrtf and an atan2f, so one firing robot's 210,000 cells
// are ~20 M operations: the card has to be filled to keep the fill near its
// bytes.
//
// What the design does about it:
//   * a work list on the device (worklist.cuh, shared with K4): every block
//     ranks the fire flags itself and takes a contiguous even share of the
//     (firing instance, level, tile of kTile cells) items; a block with no
//     share returns after the ranking;
//   * one launch, no global scratch.  A block builds its (instance, level)'s
//     256-bin minimum-range table in shared memory from the instance's
//     beams (atomicMin on the float bits: the bits of non-negative floats
//     order as the floats do; an empty bin reads as 0, as in JAX), and keeps
//     it for the next tile of the same (instance, level).  With each tile it
//     marks the tile's occupied endpoints in a shared byte map, so K2 needs
//     no global marks, no bin tables and no robot cells in global memory;
//   * one firing robot is 139 tiles of 1536 cells at 400/200/100 px, so its
//     fill spreads over every block of the grid, 8 warps each, on all 132
//     SMs.  Every block of a launch costs its dispatch however little it
//     does (a gated launch took 2.32 us at 132 blocks, 3.09 at 207, on an
//     NVIDIA H100 80GB HBM3 at 700 W), and a single robot's fill is gated
//     off on ~95% of its scans, so the grid is one block an SM for one robot
//     and up to 4 an SM for a fleet (ops/fill.py::grid_size);
//   * sqrtf and atan2f are their IEEE fast paths written out (fastpath.cuh,
//     bit for bit on these integer offsets): nvcc's test-and-call around
//     each made every cell's root and bin a branch region, so a thread's
//     cells ran one after another.  A tile's cells are read once, before
//     its beam pass so that the loads' latency passes under it, and written
//     where they change;
//   * endpoints and robot cells round half to even (__float2int_rn, as
//     dotnet_round); the free test is r_cell < table[bin] - margin.
//
// The TPU kernel's cross-product sweep over the bins replaced atan2, which
// Mosaic lacks; here the bin comes from atan2f, as on JAX's CPU path.
// Build without --use_fast_math and with -fmad=false (see ops/_build.py).

#include <cuda_runtime.h>

#include "fastpath.cuh"
#include "worklist.cuh"

constexpr int kFillMaxLevels = 4;

// Mirrored by ops/fill.py::_FillParams (ctypes, passed by value).
struct FillParams {
  int num_levels;
  int n;                                  // beams per instance
  int cells;                              // map cells per instance
  int batch;                              // instances
  int grid;                               // blocks of the launch
  int width[kFillMaxLevels];
  int offset[kFillMaxLevels];
  int tile_start[kFillMaxLevels + 1];     // an instance's tiles of each level
  float scale[kFillMaxLevels];            // map pixels per meter
  float lof;                              // log-odds free
  float loo;                              // log-odds occupied
  float cap;                              // occupied cap
  float margin;                           // free margin, pixels
};

namespace {

constexpr int kBins = 256;
constexpr int kThreads = 256;
constexpr int kTile = 1536;                          // ops/fill.py TILE
constexpr int kCellsPerThread = kTile / kThreads;
constexpr int kChunk = worklist::kChunk;
constexpr float kPi = 3.14159265358979323846f;
constexpr float kBinScale = 40.74366543152520595f;   // 256 / (2 pi)
constexpr float kEmpty = 1e9f;

// atan2f's bin; dy and dx are integers, not both zero where the bin is used
__device__ __forceinline__ int angle_bin(float dy, float dx) {
  const int b = static_cast<int>((atan2_fast(dy, dx) + kPi) * kBinScale);
  return min(max(b, 0), kBins - 1);
}

__global__ void __launch_bounds__(kThreads)
fill_kernel(float* __restrict__ maps, const float* __restrict__ points,
            const unsigned char* __restrict__ valid,
            const float* __restrict__ pose,
            const float* __restrict__ scan_pose,
            const unsigned char* __restrict__ fire, FillParams p) {
  __shared__ unsigned int s_tab[kBins];     // float bits; kEmpty: no beam
  __shared__ unsigned int s_mark[kTile / 4];   // a byte a cell of the tile
  __shared__ int s_list[kChunk];
  __shared__ int s_warp[kThreads / 32];
  unsigned char* const mark = reinterpret_cast<unsigned char*>(s_mark);

  // the firing instances, and this block's share of their work items
  const int per_inst = p.tile_start[p.num_levels];
  int n_chunk;
  long long lo, hi;
  if (!worklist::block_share<kThreads>(fire, p.batch, per_inst, s_list,
                                       s_warp, &n_chunk, &lo, &hi))
    return;                                 // the whole block

  int key = -1;             // the (instance, level) whose table s_tab holds
  bool any = false;
  int bxi = 0, byi = 0;
  bool robot_in = false;
  float c = 0.0f, s = 0.0f, tx = 0.0f, ty = 0.0f;
  long long base = 0;       // items of the chunks before this one
  for (int c0 = 0; c0 < p.batch && base < hi; c0 += kChunk) {
    if (p.batch > kChunk)
      n_chunk = worklist::rank_chunk<kThreads>(fire, c0, p.batch, s_list,
                                               s_warp);
    const long long end = base + static_cast<long long>(n_chunk) * per_inst;
    for (long long item = max(lo, base); item < min(hi, end); ++item) {
      const int rank = static_cast<int>((item - base) / per_inst);
      const int t = static_cast<int>(item - base - static_cast<long long>(rank) * per_inst);
      int level = 0;
      while (level + 1 < p.num_levels && t >= p.tile_start[level + 1]) ++level;
      const size_t inst = s_list[rank];
      const int w = p.width[level];
      const float scale = p.scale[level];
      const int tile0 = (t - p.tile_start[level]) * kTile;   // in the level
      const int k = static_cast<int>(inst) * kFillMaxLevels + level;
      const bool new_table = k != key;      // the same in every thread

      // the tile's map values, loaded first so that their latency passes
      // under the beam pass
      float* m = maps + inst * p.cells + p.offset[level];
      float v[kCellsPerThread];
#pragma unroll
      for (int q = 0; q < kCellsPerThread; ++q) {
        const int cell = tile0 + q * kThreads + threadIdx.x;
        v[q] = cell < w * w ? m[cell] : 0.0f;
      }

      __syncthreads();                      // the last tile is done
      for (int i = threadIdx.x; i < kTile / 4; i += kThreads) s_mark[i] = 0u;
      if (new_table) {
        for (int b = threadIdx.x; b < kBins; b += kThreads)
          s_tab[b] = __float_as_uint(kEmpty);
        const float* ps = pose + inst * 3;
        const float* sp = scan_pose + inst * 3;
        c = cosf(ps[2]);
        s = sinf(ps[2]);
        tx = ps[0];
        ty = ps[1];
        bxi = __float2int_rn((c * sp[0] - s * sp[1] + tx) * scale);
        byi = __float2int_rn((s * sp[0] + c * sp[1] + ty) * scale);
        robot_in = bxi >= 0 && bxi < w && byi >= 0 && byi < w;
        key = k;
      }
      __syncthreads();

      // the beams: the tile's occupied endpoints and, for a new (instance,
      // level), its bin table
      const float* pts = points + inst * p.n * 2;
      const unsigned char* val = valid + inst * p.n;
      bool any_local = false;
      for (int b = threadIdx.x; b < p.n; b += kThreads) {
        const float X = pts[2 * b], Y = pts[2 * b + 1];
        const int exi = __float2int_rn((c * X - s * Y + tx) * scale);
        const int eyi = __float2int_rn((s * X + c * Y + ty) * scale);
        const bool same = exi == bxi && eyi == byi;
        const bool ok = val[b] != 0 && !same && robot_in && exi >= 0 &&
                        exi < w && eyi >= 0 && eyi < w;
        if (!ok) continue;
        const int in_tile = eyi * w + exi - tile0;
        if (in_tile >= 0 && in_tile < kTile) mark[in_tile] = 1;
        if (new_table) {
          any_local = true;
          const float dx = static_cast<float>(exi - bxi);
          const float dy = static_cast<float>(eyi - byi);
          const float r = sqrt_fast(dx * dx + dy * dy);
          atomicMin(&s_tab[angle_bin(dy, dx)], __float_as_uint(r));
        }
      }
      if (new_table)
        any = __syncthreads_or(any_local) != 0;
      else
        __syncthreads();

      // the tile's cells, coalesced in each pass; (row, col) of the first
      // by one division, then stepped by kThreads cells.  No branch around
      // a cell's root and bin, so a thread's cells overlap
      int row = (tile0 + threadIdx.x) / w;
      int col = tile0 + threadIdx.x - row * w;
#pragma unroll
      for (int q = 0; q < kCellsPerThread; ++q) {
        const int lc = q * kThreads + threadIdx.x;
        const int cell = tile0 + lc;
        if (cell >= w * w) break;
        if (q > 0) {
          col += kThreads;
          while (col >= w) {
            col -= w;
            ++row;
          }
        }
        const bool occ = mark[lc] != 0;
        const float dx = static_cast<float>(col - bxi);
        const float dy = static_cast<float>(row - byi);
        const float r = sqrt_fast(dx * dx + dy * dy);
        const float tb = __uint_as_float(s_tab[angle_bin(dy, dx)]);
        const bool is_free = r < (tb >= kEmpty ? 0.0f : tb) - p.margin &&
                             r > 0.0f && !occ && any;
        if (is_free)
          m[cell] = v[q] + p.lof;
        else if (occ && v[q] < p.cap)
          m[cell] = v[q] + p.loo;
      }
    }
    base = end;
  }
}

}  // namespace

// One launch of p.grid blocks; fire is u8/bool[batch].
extern "C" int slamnet_fill(float* maps, const float* points,
                            const unsigned char* valid, const float* pose,
                            const float* scan_pose, const unsigned char* fire,
                            FillParams p, cudaStream_t stream) {
  if (p.batch < 1 || p.batch > 65535 || p.n < 1 || p.grid < 1 ||
      p.num_levels < 1 || p.num_levels > kFillMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  fill_kernel<<<p.grid, kThreads, 0, stream>>>(maps, points, valid, pose,
                                               scan_pose, fire, p);
  return static_cast<int>(cudaGetLastError());
}
