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
// What bounds it on an H100: bytes. At the slice's shapes it writes
// 10 x 1024 x 1024 float32 (40 MB) and reads about as much, so the floor is
// ~24 us at 3.35 TB/s. One thread per output element with the position
// index fastest makes the 40 MB of writes fully coalesced; the reads are
// strided (one run per position) but asT fits in the 50 MB L2. The TPU's
// aligned DMA windows, lane rolls and MXU transposes have no counterpart
// here. A shared-memory transpose to coalesce the reads too is later work.
#include <cuda_runtime.h>

namespace {

__global__ void expand_slab_kernel(const float* __restrict__ asT,
                                   const int* __restrict__ t_start_p, int R,
                                   int width, int cap, int num_tiles,
                                   float* __restrict__ slab) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long total = (long long)R * cap * num_tiles;
  if (i >= total) return;
  const int p = (int)(i % num_tiles);
  const long long rs = i / num_tiles;
  const int s = (int)(rs % cap);
  const int r = (int)(rs / cap);
  const int start = min(t_start_p[p], width - cap);
  slab[i] = asT[(long long)r * width + start + s];
}

}  // namespace

extern "C" int bs_expand_slab(const float* asT, const int* t_start_p, int R,
                              int width, int cap, int num_tiles, float* slab,
                              void* stream) {
  const long long total = (long long)R * cap * num_tiles;
  if (total > 0) {
    const int threads = 256;
    const long long blocks = (total + threads - 1) / threads;
    expand_slab_kernel<<<(unsigned)blocks, threads, 0,
                         (cudaStream_t)stream>>>(asT, t_start_p, R, width,
                                                 cap, num_tiles, slab);
  }
  return (int)cudaGetLastError();
}
