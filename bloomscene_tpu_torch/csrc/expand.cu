// K4 -- slab expansion: tile-sorted attribute rows -> the blend's slab.
//
// Replaces the TPU kernel bloomscene_tpu/ops/pallas/expand.py::_expand_kernel
// (driven by expand_slab, called from bloomscene_tpu/ops/tiles.py:612).
//
// What it computes:
//   slab[r, s, p] = asT[r, min(t_start_p[p], width - cap) + s]
// for r < R, s < cap, p < T: each tile's run of tile-sorted attribute rows
// becomes one column of the slab; slots past the run read the next tile's
// rows or the zero tail, which the blend masks by the tile's count.
//
// What bounds it on an H100: bytes. At the port's shapes it writes
// 10 x 1024 x 1024 float32 (42 MB) and reads ~16 MB of distinct asT
// columns, ~17 us at 3.35 TB/s. The slab's position index is fastest but a
// position's run is contiguous in asT, so the copy is a transpose: read
// along s, write along p. A block takes POS positions and SLOTS slots and
// walks the R rows: each warp reads whole runs (one position a load, a
// lane a slot: coalesced), a padded shared tile [SLOTS][POS + 1] turns
// them around without bank conflicts, and each warp writes whole 128-byte
// lines of slab[r, s, p0:p0+POS] (a lane a position). The next row's loads
// are issued before this row's stores, so each thread keeps 2 x
// PER_THREAD accesses in flight. Starts are clamped once per block, and
// the only per-element index arithmetic is adds and one multiply. Blocks
// of 64 slots, or of 128 or 512 threads, measured no faster: the copy
// moves its ~58 MB of device memory at ~2 TB/s.
#include <cuda_runtime.h>

namespace {

constexpr int POS = 32;      // positions a block: one warp's 128-byte store
constexpr int SLOTS = 32;    // slots a block: one warp's run load
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PER_THREAD = POS * SLOTS / THREADS;   // loads (stores) a row

__global__ void __launch_bounds__(THREADS) expand_slab_kernel(
    const float* __restrict__ asT, const int* __restrict__ t_start_p, int R,
    int width, int cap, int num_tiles, float* __restrict__ slab) {
  __shared__ float tile[SLOTS][POS + 1];
  __shared__ int s_start[POS];
  const int p0 = blockIdx.x * POS, s0 = blockIdx.y * SLOTS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x < POS) {
    const int p = p0 + threadIdx.x;
    s_start[threadIdx.x] = p < num_tiles ? min(t_start_p[p], width - cap) : 0;
  }
  __syncthreads();

  // loads: warp w reads positions w + WARPS * j, lane = slot
  const bool s_ok = s0 + lane < cap;
  int src[PER_THREAD];
  bool ld_ok[PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) {
    const int pl = warp + WARPS * j;
    ld_ok[j] = s_ok && p0 + pl < num_tiles;
    src[j] = s_start[pl] + s0 + lane;
  }
  // stores: warp w writes slots w + WARPS * j, lane = position
  const bool p_ok = p0 + lane < num_tiles;
  bool st_ok[PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j)
    st_ok[j] = p_ok && s0 + warp + WARPS * j < cap;

  float v[PER_THREAD];
#pragma unroll
  for (int j = 0; j < PER_THREAD; ++j) v[j] = ld_ok[j] ? asT[src[j]] : 0.0f;
  for (int r = 0; r < R; ++r) {
    __syncthreads();   // the previous row's tile has been read
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) tile[lane][warp + WARPS * j] = v[j];
    if (r + 1 < R) {
      const float* row = asT + (long long)(r + 1) * width;
#pragma unroll
      for (int j = 0; j < PER_THREAD; ++j)
        v[j] = ld_ok[j] ? row[src[j]] : 0.0f;
    }
    __syncthreads();
    float* out = slab + ((long long)r * cap + s0) * num_tiles + p0 + lane;
#pragma unroll
    for (int j = 0; j < PER_THREAD; ++j) {
      const int sl = warp + WARPS * j;
      if (st_ok[j]) out[(long long)sl * num_tiles] = tile[sl][lane];
    }
  }
}

}  // namespace

extern "C" int bs_expand_slab(const float* asT, const int* t_start_p, int R,
                              int width, int cap, int num_tiles, float* slab,
                              void* stream) {
  if ((long long)R * cap * num_tiles > 0) {
    const dim3 grid((num_tiles + POS - 1) / POS, (cap + SLOTS - 1) / SLOTS);
    expand_slab_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
        asT, t_start_p, R, width, cap, num_tiles, slab);
  }
  return (int)cudaGetLastError();
}
