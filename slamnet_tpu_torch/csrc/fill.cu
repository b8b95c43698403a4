// K2: the dense polar occupancy fill of every pyramid level, two launches a scan.
//
// Replaces the TPU kernel slamnet_tpu/ops/pallas_fill.py::polar_fill_pallas
// (body _fill_kernel) together with the beam-side prolog of its wrapper
// update_occupancy_dense_pallas; it computes what
// slamnet_tpu/ops/logodds.py::update_occupancy_dense computes for each level.
//
// What bounds it on an H100: the bytes of the maps.  Every cell of every
// level (210,000 at 400/200/100 px) is read and, when the motion gate fires,
// written once: about 1.7 MB of f32 for all levels, plus one byte of
// occupied mark per cell.  The beam side is 3 x 400 threads of scalar math.
//
// What the design does about it:
//   * launch A, the beam side: one block per level, one thread per beam.  It
//     rounds the endpoint and robot cells half to even (__float2int_rn, as
//     dotnet_round), bins each valid beam with atan2f, and takes the per-bin
//     minimum range with atomicMin on the float bits in shared memory (exact:
//     the bits of non-negative floats order as the floats do).  The 256-bin
//     table starts at 1e9 in shared memory, so no global buffer needs a reset;
//     an empty bin becomes 0 as in JAX.  Each valid endpoint stores a byte
//     mark; __syncthreads_or gives the level's any-beam flag.
//   * launch B, the cell side: one thread per cell over all levels at once,
//     each block inside one level with that level's table in shared memory.
//     A cell reads its mark, clears it (so the next scan needs no memset),
//     and, only if the device-side do_update flag is set, applies the free
//     test r_cell < table[bin] - margin (r_cell > 0, not occupied, any beam)
//     and the occupied-below-cap increment in place.  Each cell is one
//     coalesced read and at most one write: the pass is as wide as the maps.
//   * the flag is read on the device, so the motion gate never syncs the
//     host (the JAX version's lax.cond).
//
// The TPU kernel's cross-product sweep over the bins replaced atan2, which
// Mosaic lacks; here the bin comes from atan2f, as on JAX's CPU path.
// Build without --use_fast_math and with -fmad=false (see ops/_build.py).

#include <cuda_runtime.h>

constexpr int kFillMaxLevels = 4;

// Mirrored by ops/fill.py::_FillParams (ctypes, passed by value).
struct FillParams {
  int num_levels;
  int n;                                  // beams
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
                           unsigned char* __restrict__ marks,
                           float* __restrict__ tables,
                           int* __restrict__ robot, FillParams p) {
  __shared__ unsigned int s_tab[kBins];
  const int level = blockIdx.x;
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
    tables[level * kBins + k] = t >= kEmpty ? 0.0f : t;
  }
  if (threadIdx.x == 0) {
    robot[level * 4 + 0] = bxi;
    robot[level * 4 + 1] = byi;
    robot[level * 4 + 2] = any != 0;
  }
}

__global__ void fill_cells(float* __restrict__ maps,
                           unsigned char* __restrict__ marks,
                           const float* __restrict__ tables,
                           const int* __restrict__ robot,
                           const unsigned char* __restrict__ do_update,
                           FillParams p) {
  __shared__ float s_tab[kBins];
  int level = 0;
  while (level + 1 < p.num_levels &&
         static_cast<int>(blockIdx.x) >= p.block_start[level + 1])
    ++level;
  for (int k = threadIdx.x; k < kBins; k += blockDim.x)
    s_tab[k] = tables[level * kBins + k];
  __syncthreads();

  const int w = p.width[level];
  const int local = (blockIdx.x - p.block_start[level]) * blockDim.x +
                    threadIdx.x;
  if (local >= w * w) return;
  const int idx = p.offset[level] + local;
  const bool occ = marks[idx] != 0;
  if (occ) marks[idx] = 0;
  if (*do_update == 0) return;

  const int bxi = robot[level * 4 + 0], byi = robot[level * 4 + 1];
  const bool any = robot[level * 4 + 2] != 0;
  const float dx = static_cast<float>(local % w - bxi);
  const float dy = static_cast<float>(local / w - byi);
  const float r = sqrtf(dx * dx + dy * dy);
  const bool is_free = r < s_tab[angle_bin(dy, dx)] - p.margin && r > 0.0f &&
                       !occ && any;
  const float v = maps[idx];
  if (is_free)
    maps[idx] = v + p.lof;
  else if (occ && v < p.cap)
    maps[idx] = v + p.loo;
}

}  // namespace

extern "C" int slamnet_fill(float* maps, unsigned char* marks,
                            const float* points, const unsigned char* valid,
                            const float* pose, const float* scan_pose,
                            const unsigned char* do_update, float* tables,
                            int* robot, FillParams p, cudaStream_t stream) {
  int threads = ((p.n + 31) / 32) * 32;
  if (threads < 32) threads = 32;
  if (threads > 1024) threads = 1024;
  fill_beams<<<p.num_levels, threads, 0, stream>>>(points, valid, pose,
                                                   scan_pose, marks, tables,
                                                   robot, p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fill_cells<<<p.block_start[p.num_levels], kCellThreads, 0, stream>>>(
      maps, marks, tables, robot, do_update, p);
  return static_cast<int>(cudaGetLastError());
}
