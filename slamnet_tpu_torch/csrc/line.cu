// K4: the line-mode (Bresenham) log-odds occupancy update of every pyramid
// level of one robot or of a fleet, one launch a scan or batch-scan.
//
// Replaces the TPU kernel slamnet_tpu/ops/pallas_scatter.py::
// occupancy_scatter_pallas (body _scatter_kernel), together with the
// free-cell and endpoint index lists its caller would build: it computes
// what slamnet_tpu/ops/logodds.py::update_occupancy computes for each level
// (the reference's OccGridMap.UpdateByScan + Bresenham2D,
// OccGridMap.cs:114-239), for every instance whose device flag fire[b] is
// set (the single robot's lax.cond at models/hector.py:324 is the batch = 1
// case; the fleet's scan-over-instances lax.cond, models/fleet.py:244-266).
//
// What bounds it on an H100: the bytes of the cells it changes (a firing
// robot's walks change ~50,000 of its 210,000 cells at 400/200/100 px, each
// read and written once), and before them a short chain of latencies: rank
// the fire flags, round the endpoints, walk, apply.  A beam marks up to
// ~width cells of each level, so one thread walking whole beams leaves the
// card idle; a fleet fires ~1 in 18 instances a batch-scan, and the others
// must cost nothing.
//
// What the design does about it:
//   * a work list on the device (worklist.cuh, shared with K2): every block
//     ranks the fire flags itself and takes a contiguous even share of the
//     (firing instance, level, square tile of kTile x kTile cells) items; a
//     block with no share returns after the ranking, and a single robot's
//     blocks return before it when its flag is off (484 of the fixed
//     replay's 512 scans).  The grid is K2's (ops/fill.py::grid_size: one
//     block an SM for one robot, up to 4 for a fleet), at most as many an
//     SM as it holds at once (slamnet_line_blocks_per_sm), so no block of
//     a fleet's launch waits for another to end before it ranks the flags.
//     One firing robot is 81 + 25 + 9 = 115 tiles of 45 cells a side at
//     400/200/100 px: fewer than the card's 132 SMs, so no block takes two
//     (a block's second item costs a firing scan ~1.5 us on an H100);
//   * per item, each thread takes beams: it rounds the robot cell and the
//     endpoint half to even (__float2int_rn, as dotnet_round), applies the
//     beam rules (valid, begin != end, both in the map) and rejects a beam
//     whose bounding box misses the tile.  The walk's cell k lies k steps
//     along the major axis and m_k = floor((abs_da/2 + k*abs_db) / abs_da)
//     along the minor one (rasterize.hector_line_cells), both monotone in
//     k, so its cells in the tile are one interval [k0, k1] of k, found in
//     closed form: the major bound from the tile's columns (x-major) or
//     rows, the minor one by inverting m_k.  Bresenham2D's error recurrence
//     (OccGridMap.cs:220-239: add abs_db, step the minor axis and subtract
//     abs_da once it reaches abs_da) restarts at k0, so no thread walks more
//     than kTile cells of a beam in an item.  ops/line.py::tile_walk is its
//     twin, held against the walk on the CPU;
//   * marks in shared memory, a byte a cell of the tile: every beam's free
//     marks (1), a block barrier, then the tile's occupied endpoints (2), so
//     occupied wins (OccGridMap.cs:190-212) and same-value stores are the
//     only race.  A cell belongs to one tile and one block: no atomics, and
//     nothing global is written but the maps;
//   * the tile's map values are loaded before its beam pass, so their
//     latency passes under it; a marked cell becomes (v + f) + o, f =
//     log_odds_free on a free mark, o = log_odds_occupied on an occupied
//     mark under the cap: the plain version's arithmetic, in its order, so
//     the result is equal bit for bit.  The apply clears the marks it read.
//
// The TPU kernel serialized the index lists through SMEM one point at a
// time because Mosaic has no scalar VMEM store; here each beam stores its
// own bytes.  Build without --use_fast_math and with -fmad=false (see
// ops/_build.py), so the endpoints round as the plain version's do.

#include <cuda_runtime.h>

#include "worklist.cuh"

constexpr int kLineMaxLevels = 4;

// Mirrored by ops/line.py::_LineParams (ctypes, passed by value).
struct LineParams {
  int num_levels;
  int n;                                  // beams per instance
  int cells;                              // map cells per instance
  int batch;                              // instances
  int grid;                               // blocks of the launch
  int width[kLineMaxLevels];
  int offset[kLineMaxLevels];
  int tiles[kLineMaxLevels];              // tiles a side of each level
  int tile_start[kLineMaxLevels + 1];     // an instance's tiles of each level
  float scale[kLineMaxLevels];            // map pixels per meter
  float lof;                              // log-odds free
  float loo;                              // log-odds occupied
  float cap;                              // occupied cap
};

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 45;                             // ops/line.py TILE
constexpr int kTileCells = kTile * kTile;
constexpr int kCellsPerThread = (kTileCells + kThreads - 1) / kThreads;
constexpr int kMarkWords = (kTileCells + 3) / 4;
constexpr unsigned char kFree = 1;
constexpr unsigned char kOccupied = 2;

// One (instance, level): the robot's pose and cell, the level's geometry.
struct Frame {
  float c, s, tx, ty, scale;
  int bxi, byi, w;
  bool robot_in;

  __device__ void set(const float* pose, const float* scan_pose, int width,
                      float sc) {
    w = width;
    scale = sc;
    c = cosf(pose[2]);
    s = sinf(pose[2]);
    tx = pose[0];
    ty = pose[1];
    bxi = __float2int_rn((c * scan_pose[0] - s * scan_pose[1] + tx) * scale);
    byi = __float2int_rn((s * scan_pose[0] + c * scan_pose[1] + ty) * scale);
    robot_in = bxi >= 0 && bxi < w && byi >= 0 && byi < w;
  }

  // The endpoint cell of beam (X, Y), and whether the beam updates the map.
  __device__ __forceinline__ bool end(float X, float Y, bool valid, int* exi,
                                      int* eyi) const {
    *exi = __float2int_rn((c * X - s * Y + tx) * scale);
    *eyi = __float2int_rn((s * X + c * Y + ty) * scale);
    const bool same = *exi == bxi && *eyi == byi;
    return valid && !same && robot_in && *exi >= 0 && *exi < w &&
           *eyi >= 0 && *eyi < w;
  }
};

// Marks kFree the free cells of the beam (bxi, byi) -> (exi, eyi) (begin !=
// end, both in the map) that lie in the tile [x0, x0 + kTile) x
// [y0, y0 + kTile): steps [k0, k1] of its walk, by the recurrence restarted
// at k0.  ops/line.py::tile_walk computes the same.
__device__ __forceinline__ void walk_tile(int bxi, int byi, int exi, int eyi,
                                          int x0, int y0,
                                          unsigned char* mark) {
  if (max(bxi, exi) < x0 || min(bxi, exi) >= x0 + kTile ||
      max(byi, eyi) < y0 || min(byi, eyi) >= y0 + kTile)
    return;                                 // the bounding box misses
  const int dx = exi - bxi, dy = eyi - byi;
  const int adx = abs(dx), ady = abs(dy);
  const int sx = (dx > 0) - (dx < 0), sy = (dy > 0) - (dy < 0);
  const bool x_major = adx >= ady;
  const int maj = x_major ? adx : ady;      // abs_da > 0: begin != end
  const int mino = x_major ? ady : adx;     // abs_db
  const int su = x_major ? sx : sy;         // +-1
  const int sv = x_major ? sy : sx;         // +-1, or 0 with abs_db = 0
  const int u0 = x_major ? bxi : byi, v0 = x_major ? byi : bxi;
  const int ulo = x_major ? x0 : y0, vlo = x_major ? y0 : x0;
  // the major axis: u0 + k*su in [ulo, ulo + kTile)
  int k0 = max(su > 0 ? ulo - u0 : u0 - (ulo + kTile - 1), 0);
  int k1 = min(su > 0 ? ulo + kTile - 1 - u0 : u0 - ulo, maj - 1);
  const int e0 = maj / 2;
  if (mino > 0) {   // the minor axis: v0 + m_k*sv in [vlo, vlo + kTile)
    // (with abs_db = 0 the bounding box has placed the line in the tile)
    const int mlo = sv > 0 ? vlo - v0 : v0 - (vlo + kTile - 1);
    const int mhi = sv > 0 ? vlo + kTile - 1 - v0 : v0 - vlo;
    const int a = mlo * maj - e0;           // m_k >= mlo <=> k*abs_db >= a
    if (a > 0) k0 = max(k0, (a + mino - 1) / mino);
    const int b = (mhi + 1) * maj - e0 - 1; // m_k <= mhi <=> k*abs_db <= b
    if (b < 0) return;
    k1 = min(k1, b / mino);
  }
  if (k0 > k1) return;
  const int num = e0 + k0 * mino;           // >= 0
  const int m = num / maj;
  int err = num - m * maj;                  // in [0, abs_da), as at step k0
  const int lu = u0 + k0 * su - ulo, lv = v0 + m * sv - vlo;
  int cell = x_major ? lv * kTile + lu : lu * kTile + lv;
  const int off_major = x_major ? su : su * kTile;
  const int off_minor = x_major ? sv * kTile : sv;
  for (int k = k0; k <= k1; ++k) {
    mark[cell] = kFree;
    cell += off_major;
    err += mino;
    if (err >= maj) {
      err -= maj;
      cell += off_minor;
    }
  }
}

__global__ void __launch_bounds__(kThreads)
line_kernel(float* __restrict__ maps, const float* __restrict__ points,
            const unsigned char* __restrict__ valid,
            const float* __restrict__ pose,
            const float* __restrict__ scan_pose,
            const unsigned char* __restrict__ fire, LineParams p) {
  __shared__ unsigned int s_mark[kMarkWords];   // a byte a cell of the tile
  __shared__ int s_list[worklist::kChunk];
  __shared__ int s_warp[kThreads / 32];
  unsigned char* const mark = reinterpret_cast<unsigned char*>(s_mark);
  if (p.batch == 1 && fire[0] == 0) return;   // one robot, gated: no ranking

  // the firing instances, and this block's share of their work items
  const int per_inst = p.tile_start[p.num_levels];
  int n_chunk;
  long long lo, hi;
  if (!worklist::block_share<kThreads>(fire, p.batch, per_inst, s_list,
                                       s_warp, &n_chunk, &lo, &hi))
    return;                                 // the whole block
  for (int i = threadIdx.x; i < kMarkWords; i += kThreads) s_mark[i] = 0u;
  __syncthreads();

  int key = -1;             // the (instance, level) whose frame g holds
  Frame g;
  long long base = 0;       // items of the chunks before this one
  for (int c0 = 0; c0 < p.batch && base < hi; c0 += worklist::kChunk) {
    if (p.batch > worklist::kChunk)
      n_chunk = worklist::rank_chunk<kThreads>(fire, c0, p.batch, s_list,
                                               s_warp);
    const long long end = base + static_cast<long long>(n_chunk) * per_inst;
    for (long long item = max(lo, base); item < min(hi, end); ++item) {
      const int rank = static_cast<int>((item - base) / per_inst);
      const int t = static_cast<int>(item - base - static_cast<long long>(rank) * per_inst);
      int level = 0;
      while (level + 1 < p.num_levels && t >= p.tile_start[level + 1]) ++level;
      const size_t inst = s_list[rank];
      const int k = static_cast<int>(inst) * kLineMaxLevels + level;
      if (k != key) {                       // the same in every thread
        g.set(pose + inst * 3, scan_pose + inst * 3, p.width[level],
              p.scale[level]);
        key = k;
      }
      if (!g.robot_in) continue;            // no beam counts: the whole block
      const int tl = t - p.tile_start[level];
      const int row = tl / p.tiles[level];
      const int y0 = row * kTile, x0 = (tl - row * p.tiles[level]) * kTile;

      // the tile's map values, loaded first so that their latency passes
      // under the beam pass
      float* m = maps + inst * p.cells + p.offset[level];
      float v[kCellsPerThread];
#pragma unroll
      for (int q = 0; q < kCellsPerThread; ++q) {
        const int lc = q * kThreads + threadIdx.x;
        const int x = x0 + lc % kTile, y = y0 + lc / kTile;
        v[q] = lc < kTileCells && x < g.w && y < g.w ? m[y * g.w + x] : 0.0f;
      }

      // every beam's free cells in the tile, endpoint excluded
      const float* pts = points + inst * p.n * 2;
      const unsigned char* val = valid + inst * p.n;
      for (int b = threadIdx.x; b < p.n; b += kThreads) {
        int exi, eyi;
        if (g.end(pts[2 * b], pts[2 * b + 1], val[b] != 0, &exi, &eyi))
          walk_tile(g.bxi, g.byi, exi, eyi, x0, y0, mark);
      }
      __syncthreads();      // every free mark of the tile before any occupied

      // the tile's occupied endpoints, overriding free
      for (int b = threadIdx.x; b < p.n; b += kThreads) {
        int exi, eyi;
        if (g.end(pts[2 * b], pts[2 * b + 1], val[b] != 0, &exi, &eyi) &&
            exi >= x0 && exi < x0 + kTile && eyi >= y0 && eyi < y0 + kTile)
          mark[(eyi - y0) * kTile + exi - x0] = kOccupied;
      }
      __syncthreads();

      // the marked cells (all in the map), each read and written once; the
      // marks are cleared for the next item
#pragma unroll
      for (int q = 0; q < kCellsPerThread; ++q) {
        const int lc = q * kThreads + threadIdx.x;
        if (lc >= kTileCells) break;
        const unsigned char mk = mark[lc];
        if (mk == 0) continue;
        mark[lc] = 0;
        const float f = mk == kFree ? p.lof : 0.0f;
        const float o = (mk == kOccupied && v[q] < p.cap) ? p.loo : 0.0f;
        m[(y0 + lc / kTile) * g.w + x0 + lc % kTile] = (v[q] + f) + o;
      }
      __syncthreads();                      // the marks are clear again
    }
    base = end;
  }
}

}  // namespace

// How many blocks of line_kernel an SM holds at once (its registers and
// shared memory decide): ops/line.py sizes the grid by it.
extern "C" int slamnet_line_blocks_per_sm(int* blocks) {
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, line_kernel, kThreads, 0));
}

// One launch of p.grid blocks; fire is u8/bool[batch].
extern "C" int slamnet_line(float* maps, const float* points,
                            const unsigned char* valid, const float* pose,
                            const float* scan_pose, const unsigned char* fire,
                            LineParams p, cudaStream_t stream) {
  if (p.batch < 1 || p.batch > 65535 || p.n < 1 || p.grid < 1 ||
      p.num_levels < 1 || p.num_levels > kLineMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  line_kernel<<<p.grid, kThreads, 0, stream>>>(maps, points, valid, pose,
                                               scan_pose, fire, p);
  return static_cast<int>(cudaGetLastError());
}
