// K4: the line-mode (Bresenham) log-odds occupancy update of every pyramid
// level of one robot or of a fleet, two launches a scan or batch-scan.
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
// What bounds it on an H100: the walks, then the bytes of the maps.  A beam
// marks up to ~width cells of each level (400 beams x up to 400 cells at the
// 400 px level); the apply pass reads one mark byte a cell over every level
// of a firing instance (210,000 cells at 400/200/100 px) and rewrites only
// the marked cells.  A fleet fires ~1 in 18 instances a batch-scan; the
// blocks of the others read one flag and return.
//
// What the design does about it:
//   * launch A, the beam side: one block per (level, instance), one thread
//     per beam (looping when a scan has more beams than a block has
//     threads); a block whose instance does not fire returns at once.  It
//     rounds the robot cell and each endpoint half to even (__float2int_rn,
//     as dotnet_round), applies the beam rules (valid, begin != end, both in
//     the map), and walks the beam's abs_da free cells with Bresenham2D's
//     own error recurrence (OccGridMap.cs:220-239: add abs_db, step the
//     minor axis and subtract abs_da once it reaches abs_da), which visits
//     exactly the cells of rasterize.hector_line_cells' closed form
//     m_k = floor((abs_da/2 + k*abs_db) / abs_da) without a division a cell,
//     storing byte marks into the marks scratch (1 = free, 2 = occupied).
//   * the race: two beams may store "free" (1) and "occupied" (2) into the
//     same byte, and occupied must win (OccGridMap.cs:190-212).  Equal-value
//     stores are benign, mixed ones are not.  Every beam of one (level,
//     instance) lies in one block, and no other block writes that level's
//     cells, so the block marks free cells, passes __syncthreads() (which
//     orders the block's global stores), then marks the occupied endpoints:
//     the two phases of two launches, without a second launch and without
//     word-wide atomics on the byte scratch.
//   * launch B, the cell side: K2's launch-B pattern over all cells of all
//     levels of all instances (grid: 4096-cell blocks of one instance x
//     instances); a block whose instance does not fire returns after reading
//     the flag (it has no marks).  A marked cell clears its mark (so the next
//     scan needs no memset) and becomes (v + f) + o, f = log_odds_free on a
//     free mark, o = log_odds_occupied on an occupied mark under the cap:
//     the plain version's arithmetic, in its order, so the result is equal
//     bit for bit.
//   * the flags are read on the device, so the motion gates never sync the
//     host, and no launch size depends on how many instances fire.
//
// The TPU kernel serialized the index lists through SMEM one point at a
// time because Mosaic has no scalar VMEM store; here each beam stores its
// own bytes.  Build without --use_fast_math and with -fmad=false (see
// ops/_build.py), so the endpoints round as the plain version's do.

#include <cuda_runtime.h>

constexpr int kLineMaxLevels = 4;

// Mirrored by ops/line.py::_LineParams (ctypes, passed by value).
struct LineParams {
  int num_levels;
  int n;                                  // beams per instance
  int cells;                              // map cells per instance
  int batch;                              // instances
  int width[kLineMaxLevels];
  int offset[kLineMaxLevels];
  float scale[kLineMaxLevels];            // map pixels per meter
  float lof;                              // log-odds free
  float loo;                              // log-odds occupied
  float cap;                              // occupied cap
};

namespace {

constexpr int kCellThreads = 256;
constexpr int kCellsPerThread = 16;   // a launch B block covers 4096 cells
constexpr unsigned char kFree = 1;
constexpr unsigned char kOccupied = 2;

struct Beams {
  float c, s, tx, ty, scale;
  int bxi, byi, w;
  bool robot_in;

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

__global__ void line_beams(const float* __restrict__ points,
                           const unsigned char* __restrict__ valid,
                           const float* __restrict__ pose,
                           const float* __restrict__ scan_pose,
                           const unsigned char* __restrict__ fire,
                           unsigned char* __restrict__ marks, LineParams p) {
  const int level = blockIdx.x;
  const size_t inst = blockIdx.y;
  if (fire[inst] == 0) return;              // the whole block: no marks
  points += inst * p.n * 2;
  valid += inst * p.n;
  pose += inst * 3;
  scan_pose += inst * 3;
  marks += inst * p.cells + p.offset[level];

  Beams g;
  g.w = p.width[level];
  g.scale = p.scale[level];
  g.c = cosf(pose[2]);
  g.s = sinf(pose[2]);
  g.tx = pose[0];
  g.ty = pose[1];
  g.bxi = __float2int_rn((g.c * scan_pose[0] - g.s * scan_pose[1] + g.tx) *
                         g.scale);
  g.byi = __float2int_rn((g.s * scan_pose[0] + g.c * scan_pose[1] + g.ty) *
                         g.scale);
  g.robot_in = g.bxi >= 0 && g.bxi < g.w && g.byi >= 0 && g.byi < g.w;
  const int start = g.byi * g.w + g.bxi;

  // phase 1: every beam's free cells, endpoint excluded (Bresenham2D)
  for (int b = threadIdx.x; b < p.n; b += blockDim.x) {
    int exi, eyi;
    if (!g.end(points[2 * b], points[2 * b + 1], valid[b] != 0, &exi, &eyi))
      continue;
    const int dx = exi - g.bxi, dy = eyi - g.byi;
    const int adx = abs(dx), ady = abs(dy);
    const int sx = (dx > 0) - (dx < 0), sy = (dy > 0) - (dy < 0);
    const bool x_major = adx >= ady;
    const int maj = x_major ? adx : ady;          // abs_da > 0: begin != end
    const int mino = x_major ? ady : adx;         // abs_db
    const int off_major = x_major ? sx : sy * g.w;
    const int off_minor = x_major ? sy * g.w : sx;
    int cell = start;
    int err = maj / 2;          // stays in [0, abs_da): abs_db <= abs_da
    for (int k = 0; k < maj; ++k) {
      marks[cell] = kFree;
      cell += off_major;
      err += mino;
      if (err >= maj) {
        err -= maj;
        cell += off_minor;
      }
    }
  }
  __syncthreads();    // every free mark of this level before any occupied one

  // phase 2: the occupied endpoints, overriding free
  for (int b = threadIdx.x; b < p.n; b += blockDim.x) {
    int exi, eyi;
    if (g.end(points[2 * b], points[2 * b + 1], valid[b] != 0, &exi, &eyi))
      marks[eyi * g.w + exi] = kOccupied;
  }
}

__global__ void line_cells(float* __restrict__ maps,
                           unsigned char* __restrict__ marks,
                           const unsigned char* __restrict__ fire,
                           LineParams p) {
  const size_t inst = blockIdx.y;
  if (fire[inst] == 0) return;              // the whole block
  maps += inst * p.cells;
  marks += inst * p.cells;
  const int first = blockIdx.x * kCellThreads * kCellsPerThread + threadIdx.x;
  for (int k = 0; k < kCellsPerThread; ++k) {
    const int idx = first + k * kCellThreads;     // coalesced in each pass
    if (idx >= p.cells) return;
    const unsigned char m = marks[idx];
    if (m == 0) continue;
    marks[idx] = 0;
    const float v = maps[idx];
    const float f = m == kFree ? p.lof : 0.0f;
    const float o = (m == kOccupied && v < p.cap) ? p.loo : 0.0f;
    maps[idx] = (v + f) + o;
  }
}

}  // namespace

// Launch A over (level, instance), then launch B over (cell blocks of one
// instance, instance); fire is u8/bool[batch].
extern "C" int slamnet_line(float* maps, unsigned char* marks,
                            const float* points, const unsigned char* valid,
                            const float* pose, const float* scan_pose,
                            const unsigned char* fire, LineParams p,
                            cudaStream_t stream) {
  int threads = ((p.n + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  if (threads > 1024) threads = 1024;
  if (p.batch < 1 || p.batch > 65535 || p.num_levels < 1 ||
      p.num_levels > kLineMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  line_beams<<<dim3(p.num_levels, p.batch), threads, 0, stream>>>(
      points, valid, pose, scan_pose, fire, marks, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int per_block = kCellThreads * kCellsPerThread;
  line_cells<<<dim3((p.cells + per_block - 1) / per_block, p.batch),
               kCellThreads, 0, stream>>>(maps, marks, fire, p);
  return static_cast<int>(cudaGetLastError());
}
