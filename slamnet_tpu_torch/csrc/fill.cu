// K2: the dense polar occupancy fill of every pyramid level of one robot or
// of a fleet, two launches a scan or batch-scan.
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
// What bounds it on an H100: the bytes of the maps.  Every cell of every
// level of a firing instance (210,000 at 400/200/100 px) is read and written
// at most once: about 1.7 MB of f32 for all levels, plus one byte of occupied
// mark per cell.  A fleet fires ~1 in 18 instances a batch-scan; the blocks
// of the others read one flag and return.  The beam side is 3 x 400 threads
// of scalar math an instance.
//
// What the design does about it:
//   * launch A, the beam side: one block per (level, instance), one thread
//     per beam; a block whose instance does not fire returns at once.  It
//     rounds the endpoint and robot cells half to even (__float2int_rn, as
//     dotnet_round), bins each valid beam with atan2f, and takes the per-bin
//     minimum range with atomicMin on the float bits in shared memory (exact:
//     the bits of non-negative floats order as the floats do).  The 256-bin
//     table starts at 1e9 in shared memory, so no global buffer needs a reset;
//     an empty bin becomes 0 as in JAX.  Each valid endpoint stores a byte
//     mark; __syncthreads_or gives the level's any-beam flag.
//   * launch B, the cell side: every cell of all levels of all instances
//     (grid: the blocks of one instance's levels x instances), each block
//     4096 cells of one level (16 coalesced passes of 256 threads) with that
//     level's table in shared memory.  A block whose instance does not fire
//     returns after reading the flag (it has no marks to clear).  Blocks of
//     4096 cells rather than 256 keep the fleet's non-firing blocks few: at
//     64 robots, 256-cell blocks made 52,608 blocks a batch-scan, and
//     dispatching them cost ~0.33 ms of device time however few robots fired
//     (NVIDIA H100 80GB HBM3, 700 W); 4096-cell blocks make 3,392.  A cell reads its mark, clears it (so the next
//     scan needs no memset), and applies the free test
//     r_cell < table[bin] - margin (r_cell > 0, not occupied, any beam) and
//     the occupied-below-cap increment in place.  Each cell is one coalesced
//     read and at most one write: the pass is as wide as the firing maps.
//   * the flags are read on the device, so the motion gates never sync the
//     host, and no launch size depends on how many instances fire.
//
// The TPU kernel's cross-product sweep over the bins replaced atan2, which
// Mosaic lacks; here the bin comes from atan2f, as on JAX's CPU path.
// Build without --use_fast_math and with -fmad=false (see ops/_build.py).

#include <cuda_runtime.h>

constexpr int kFillMaxLevels = 4;

// Mirrored by ops/fill.py::_FillParams (ctypes, passed by value).
struct FillParams {
  int num_levels;
  int n;                                  // beams per instance
  int cells;                              // map cells per instance
  int batch;                              // instances
  int width[kFillMaxLevels];
  int offset[kFillMaxLevels];
  int block_start[kFillMaxLevels + 1];    // launch B blocks of each level
  float scale[kFillMaxLevels];            // map pixels per meter
  float lof;                              // log-odds free
  float loo;                              // log-odds occupied
  float cap;                              // occupied cap
  float margin;                           // free margin, pixels
};

namespace {

constexpr int kBins = 256;
constexpr int kCellThreads = 256;
constexpr int kCellsPerThread = 16;   // a launch B block covers 4096 cells
constexpr float kPi = 3.14159265358979323846f;
constexpr float kBinScale = 40.74366543152520595f;   // 256 / (2 pi)
constexpr float kEmpty = 1e9f;

__device__ __forceinline__ int angle_bin(float dy, float dx) {
  const int b = static_cast<int>((atan2f(dy, dx) + kPi) * kBinScale);
  return min(max(b, 0), kBins - 1);
}

__global__ void fill_beams(const float* __restrict__ points,
                           const unsigned char* __restrict__ valid,
                           const float* __restrict__ pose,
                           const float* __restrict__ scan_pose,
                           const unsigned char* __restrict__ fire,
                           unsigned char* __restrict__ marks,
                           float* __restrict__ tables,
                           int* __restrict__ robot, FillParams p) {
  __shared__ unsigned int s_tab[kBins];
  const int level = blockIdx.x;
  const size_t inst = blockIdx.y;
  if (fire[inst] == 0) return;              // the whole block: no marks
  points += inst * p.n * 2;
  valid += inst * p.n;
  pose += inst * 3;
  scan_pose += inst * 3;
  marks += inst * p.cells;
  tables += (inst * p.num_levels + level) * kBins;
  robot += (inst * p.num_levels + level) * 4;
  const int w = p.width[level];
  const float scale = p.scale[level];
  for (int k = threadIdx.x; k < kBins; k += blockDim.x)
    s_tab[k] = __float_as_uint(kEmpty);

  const float c = cosf(pose[2]), s = sinf(pose[2]);
  const float tx = pose[0], ty = pose[1];
  const int bxi = __float2int_rn((c * scan_pose[0] - s * scan_pose[1] + tx) * scale);
  const int byi = __float2int_rn((s * scan_pose[0] + c * scan_pose[1] + ty) * scale);
  const bool robot_in = bxi >= 0 && bxi < w && byi >= 0 && byi < w;
  __syncthreads();

  bool any_local = false;
  for (int b = threadIdx.x; b < p.n; b += blockDim.x) {
    const float X = points[2 * b], Y = points[2 * b + 1];
    const int exi = __float2int_rn((c * X - s * Y + tx) * scale);
    const int eyi = __float2int_rn((s * X + c * Y + ty) * scale);
    const bool same = exi == bxi && eyi == byi;
    const bool ok = valid[b] != 0 && !same && robot_in && exi >= 0 &&
                    exi < w && eyi >= 0 && eyi < w;
    if (!ok) continue;
    any_local = true;
    const float dx = static_cast<float>(exi - bxi);
    const float dy = static_cast<float>(eyi - byi);
    const float r = sqrtf(dx * dx + dy * dy);
    atomicMin(&s_tab[angle_bin(dy, dx)], __float_as_uint(r));
    marks[p.offset[level] + eyi * w + exi] = 1;
  }
  const int any = __syncthreads_or(any_local);

  for (int k = threadIdx.x; k < kBins; k += blockDim.x) {
    const float t = __uint_as_float(s_tab[k]);
    tables[k] = t >= kEmpty ? 0.0f : t;
  }
  if (threadIdx.x == 0) {
    robot[0] = bxi;
    robot[1] = byi;
    robot[2] = any != 0;
  }
}

__global__ void fill_cells(float* __restrict__ maps,
                           unsigned char* __restrict__ marks,
                           const float* __restrict__ tables,
                           const int* __restrict__ robot,
                           const unsigned char* __restrict__ fire,
                           FillParams p) {
  __shared__ float s_tab[kBins];
  const size_t inst = blockIdx.y;
  if (fire[inst] == 0) return;              // the whole block
  int level = 0;
  while (level + 1 < p.num_levels &&
         static_cast<int>(blockIdx.x) >= p.block_start[level + 1])
    ++level;
  maps += inst * p.cells;
  marks += inst * p.cells;
  tables += (inst * p.num_levels + level) * kBins;
  robot += (inst * p.num_levels + level) * 4;
  for (int k = threadIdx.x; k < kBins; k += blockDim.x)
    s_tab[k] = tables[k];
  __syncthreads();

  const int w = p.width[level];
  const int bxi = robot[0], byi = robot[1];
  const bool any = robot[2] != 0;
  const int first = (blockIdx.x - p.block_start[level]) * kCellThreads *
                    kCellsPerThread + threadIdx.x;
  for (int k = 0; k < kCellsPerThread; ++k) {
    const int local = first + k * kCellThreads;   // coalesced in each pass
    if (local >= w * w) return;
    const int idx = p.offset[level] + local;
    const bool occ = marks[idx] != 0;
    if (occ) marks[idx] = 0;

    const float dx = static_cast<float>(local % w - bxi);
    const float dy = static_cast<float>(local / w - byi);
    const float r = sqrtf(dx * dx + dy * dy);
    const bool is_free = r < s_tab[angle_bin(dy, dx)] - p.margin &&
                         r > 0.0f && !occ && any;
    const float v = maps[idx];
    if (is_free)
      maps[idx] = v + p.lof;
    else if (occ && v < p.cap)
      maps[idx] = v + p.loo;
  }
}

}  // namespace

// Launch A over (level, instance), then launch B over (cell blocks of one
// instance's levels, instance); fire is u8/bool[batch].
extern "C" int slamnet_fill(float* maps, unsigned char* marks,
                            const float* points, const unsigned char* valid,
                            const float* pose, const float* scan_pose,
                            const unsigned char* fire, float* tables,
                            int* robot, FillParams p, cudaStream_t stream) {
  int threads = ((p.n + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  if (threads > 1024) threads = 1024;
  if (p.batch < 1 || p.batch > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  fill_beams<<<dim3(p.num_levels, p.batch), threads, 0, stream>>>(
      points, valid, pose, scan_pose, fire, marks, tables, robot, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fill_cells<<<dim3(p.block_start[p.num_levels], p.batch), kCellThreads, 0,
               stream>>>(maps, marks, tables, robot, fire, p);
  return static_cast<int>(cudaGetLastError());
}
