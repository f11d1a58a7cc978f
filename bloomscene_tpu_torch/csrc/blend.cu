// K1 -- blend forward: front-to-back blend of each tile over its slab column.
//
// Replaces the TPU kernel bloomscene_tpu/ops/pallas/blend.py::_fwd_kernel
// (pallas_call at blend.py:298 in _blend_forward_local, driven by
// blend_forward_pallas and bloomscene_tpu/ops/pallas/wrapper.py::_fwd_impl).
//
// What it computes, per pixel of the tile at position p (tile id tid[p]),
// over the slots s < counts_p[p] of slab[:, s, p] (rows mx, my, conic a, b,
// c, opacity, depth, r, g, b), in order:
//   power = -0.5 (a dx^2 + c dy^2) - b dx dy; skip if power > 0;
//   alpha = min(0.99, opacity e^power); skip if alpha < 1/255;
//   stop for good when T (1 - alpha) < 1e-4 (that splat is not blended);
//   w = alpha T; C += w rgb; D += w depth; acc += w (seeded 1e-6); T *= 1-alpha.
// Outputs, each [P, T] in position space: r, g, b, D, acc, T (float32) and
// n_contrib (int32, the 1-based slot of the last blended splat).
//
// What bounds it on an H100: operations at this slice's shapes -- each
// (pixel, splat) step is ~30 float operations and one exp, against ~40
// bytes per splat shared by 256 pixels. Design: one block per tile position
// with one thread per pixel (the reference renderCUDA shape); splats are
// staged through shared memory in batches of 256 so every attribute is read
// from device memory once per tile, and the block leaves as soon as all its
// pixels have stopped (__syncthreads_count). The TPU's 128-tile lane groups,
// occupancy-sorted group maxima and unrolled chains have no counterpart:
// blocks are per tile, so there is no group to balance.
//
// Built with --fmad=false so that power, T and the sums round as the plain
// version's separate multiplies and adds do; a contracted FMA could move a
// pixel across the 1e-4 stop or the 1/255 skip.
#include <cuda_runtime.h>

namespace {

constexpr int DATA_W = 10;
constexpr int BATCH = 256;
// the JAX package's constants (ops/reference_rasterizer.py), rounded from
// double to float as a float32 comparison with a Python float rounds them
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float ALPHA_MAX = (float)0.99;
constexpr float T_EPS = (float)1e-4;
constexpr float ACC_SEED = (float)1e-6;

__global__ void blend_fwd_kernel(const float* __restrict__ slab,
                                 const int* __restrict__ counts_p,
                                 const int* __restrict__ tid, int cap,
                                 int num_tiles, int tile, int gx,
                                 float* __restrict__ planes,
                                 int* __restrict__ ncon_out) {
  __shared__ float sh[DATA_W][BATCH];
  const int p = blockIdx.x;
  const int P = tile * tile;
  const int sp = threadIdx.x;
  const int t = tid[p];
  const float px = (float)((t % gx) * tile + sp % tile);
  const float py = (float)((t / gx) * tile + sp / tile);
  const int cnt = counts_p[p];

  float T = 1.0f, Cr = 0.0f, Cg = 0.0f, Cb = 0.0f, D = 0.0f, acc = ACC_SEED;
  int done = 0, ncon = 0;
  for (int base = 0; base < cnt; base += BATCH) {
    // also the barrier that keeps the previous batch in shared memory
    // until every pixel has read it
    if (__syncthreads_count(!done) == 0) break;
    const int nb = min(BATCH, cnt - base);
    for (int i = threadIdx.x; i < DATA_W * nb; i += blockDim.x) {
      const int r = i / nb, j = i % nb;
      sh[r][j] = slab[((long long)r * cap + base + j) * num_tiles + p];
    }
    __syncthreads();
    for (int j = 0; j < nb && !done; ++j) {
      const float dx = sh[0][j] - px;
      const float dy = sh[1][j] - py;
      const float power = -0.5f * (sh[2][j] * dx * dx + sh[4][j] * dy * dy) -
                          sh[3][j] * dx * dy;
      const float alpha = fminf(ALPHA_MAX, sh[5][j] * expf(power));
      if (!(power <= 0.0f) || !(alpha >= ALPHA_MIN)) continue;
      const float test_T = T * (1.0f - alpha);
      if (test_T < T_EPS) {
        done = 1;
        break;
      }
      const float w = alpha * T;
      Cr = Cr + w * sh[7][j];
      Cg = Cg + w * sh[8][j];
      Cb = Cb + w * sh[9][j];
      D = D + w * sh[6][j];
      acc = acc + w;
      T = test_T;
      ncon = base + j + 1;
    }
  }
  const long long plane = (long long)P * num_tiles;
  const long long o = (long long)sp * num_tiles + p;
  planes[o] = Cr;
  planes[plane + o] = Cg;
  planes[2 * plane + o] = Cb;
  planes[3 * plane + o] = D;
  planes[4 * plane + o] = acc;
  planes[5 * plane + o] = T;
  ncon_out[o] = ncon;
}

}  // namespace

extern "C" int bs_blend_forward(const float* slab, const int* counts_p,
                                const int* tid, int cap, int num_tiles,
                                int tile, int gx, float* planes,
                                int* ncon_out, void* stream) {
  if (num_tiles > 0) {
    blend_fwd_kernel<<<num_tiles, tile * tile, 0, (cudaStream_t)stream>>>(
        slab, counts_p, tid, cap, num_tiles, tile, gx, planes, ncon_out);
  }
  return (int)cudaGetLastError();
}
