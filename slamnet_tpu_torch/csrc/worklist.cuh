// The device work list of the map updates K2 (fill.cu) and K4 (line.cu).
//
// A launch's grid comes from B and the card's SM count
// (ops/fill.py::grid_size), never from how many instances fire, so the
// launch is capture-safe and the host never waits.  Every block ranks the
// fire flags itself: each thread takes kChunk / kThreads flags, and a block
// prefix sum gives each firing instance its rank, in instance order, in a
// shared list of up to kChunk instances (B above kChunk goes chunk by chunk,
// every block reading all B flags: meant for B up to kChunk, correct for
// every B the wrappers take).  The work items are (firing instance, level,
// tile), per_inst an instance; block k of G takes the items
// [k*I/G, (k+1)*I/G) of the I, a contiguous even share, so the tiles of one
// (instance, level) fall mostly to one block in a row.  A block with no
// share returns after the ranking: an instance that does not fire costs one
// flag read in each block.

#pragma once

#include <cuda_runtime.h>

namespace worklist {

constexpr int kChunk = 2048;                         // instances ranked at once
constexpr unsigned kFull = 0xffffffffu;

// Exclusive prefix sum of v over the block; *total gets the block's sum.
// The caller passes a barrier before s_warp is written again.
template <int kThreads>
__device__ int block_scan(int v, int* s_warp, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) s_warp[warp] = x;
  __syncthreads();
  int before = 0, sum = 0;
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    const int t = s_warp[w];
    if (w < warp) before += t;
    sum += t;
  }
  *total = sum;
  return before + x - v;
}

// Lists the firing instances of [c0, c0 + kChunk) in s_list in instance
// order; returns how many fire.
template <int kThreads>
__device__ int rank_chunk(const unsigned char* __restrict__ fire, int c0,
                          int batch, int* s_list, int* s_warp) {
  constexpr int kFlagsPerThread = kChunk / kThreads;
  __syncthreads();                      // s_list and s_warp are free again
  const int first = c0 + threadIdx.x * kFlagsPerThread;
  unsigned bits = 0;
#pragma unroll
  for (int k = 0; k < kFlagsPerThread; ++k)
    if (first + k < batch && fire[first + k] != 0) bits |= 1u << k;
  int total;
  int pos = block_scan<kThreads>(__popc(bits), s_warp, &total);
#pragma unroll
  for (int k = 0; k < kFlagsPerThread; ++k)
    if ((bits >> k) & 1u) s_list[pos++] = first + k;
  __syncthreads();
  return total;
}

// This block's share [*lo, *hi) of the items of the firing instances,
// per_inst items each.  For B <= kChunk the firing instances are ranked in
// s_list and *n_chunk holds their count; above, the caller ranks each chunk
// with rank_chunk as it walks its share.  Returns false, the same in every
// thread, when the share is empty.
template <int kThreads>
__device__ bool block_share(const unsigned char* __restrict__ fire, int batch,
                            int per_inst, int* s_list, int* s_warp,
                            int* n_chunk, long long* lo, long long* hi) {
  long long n_fire;
  *n_chunk = 0;
  if (batch <= kChunk) {
    *n_chunk = rank_chunk<kThreads>(fire, 0, batch, s_list, s_warp);
    n_fire = *n_chunk;
  } else {
    int cnt = 0;
    for (int i = threadIdx.x; i < batch; i += kThreads) cnt += fire[i] != 0;
    int total;
    block_scan<kThreads>(cnt, s_warp, &total);
    n_fire = total;
  }
  const long long items = n_fire * per_inst;
  *lo = items * blockIdx.x / gridDim.x;
  *hi = items * (blockIdx.x + 1) / gridDim.x;
  return *lo < *hi;
}

}  // namespace worklist
