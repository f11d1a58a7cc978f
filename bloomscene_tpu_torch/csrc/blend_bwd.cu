// K2 -- blend backward: back-to-front walk of each tile, per-entry gradients.
//
// Replaces the TPU kernel bloomscene_tpu/ops/pallas/blend.py::_bwd_kernel
// (pallas_call at blend.py:539 in _blend_backward_local, driven by
// blend_backward_pallas and bloomscene_tpu/ops/pallas/wrapper.py::_bwd).
//
// What it computes, per pixel of the tile at position p (tile id tid[p]),
// walking the slots s of slab[:, s, p] from the tile's walk - 1 down to 0,
// where walk = min(counts_p[p], max over the tile's pixels of n_contrib):
//   a slot is blended at a pixel iff power <= 0, alpha >= 1/255 and
//   s < n_contrib of that pixel (the forward's rule);
//   T <- T / (1 - alpha) (starting at final T), w = alpha T;
//   dL/dalpha = T (u . c) + (tb - Q) / (1 - alpha) with tb = -T_final
//   bg_term, Q = u . S, S the strictly-behind suffix sums of w * (r, g, b,
//   depth, 1) -- the 5-carry suffix form of blend.py:387-418;
//   h = G dL/dalpha where op G < 0.99 (the alpha clamp), else 0.
// Per slot, summed over the tile's pixels: h, h dx, h dy, h dx^2, h dx dy,
// h dy^2 and w * (u_d, u_r, u_g, u_b); from these one thread writes the 10
// gradient rows of that slot: d mx, d my, d conic a, b, c, d opacity,
// d depth, d r, d g, d b (blend.py:448-459). Rows at or past the walk are
// not written; the wrapper hands in a zeroed buffer.
//
// What bounds it on an H100: operations -- each (pixel, slot) step is ~71
// float operations (one exp among them; chip_smoke.py counts them), against
// ~40 bytes of slab per slot shared by 256 pixels and 40 bytes of gradient
// written per slot. Design (simple
// and right first): one block per tile position, one thread per pixel, as
// K1; the walked slots are staged in shared memory in batches of 256 from
// the top down; each slot's ten pixel sums are a fixed tree -- a
// __shfl_down_sync tree inside each warp, then one thread per channel
// adds the warp partials in warp order -- so two runs give the same bits
// (no atomics). The warp partials are double-buffered, one barrier a slot.
//
// Built with --fmad=false, and every expression keeps the order of the
// plain version (ops/cuda/blend.py::blend_backward_plain), so the per-pixel
// values round alike; only the pixel sums' order differs.
#include <cuda_runtime.h>

namespace {

constexpr int DATA_W = 10;
constexpr int GRAD_W = 10;
constexpr int BATCH = 256;
constexpr int MAX_WARPS = 32;
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float ALPHA_MAX = (float)0.99;

// sum over the 32 lanes in a fixed tree; lane 0 holds the result
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_down_sync(0xffffffffu, v, off);
  return v;
}

// the warps' partial sums added in warp order
__device__ __forceinline__ float sum_warps(const float* part, int n_warps) {
  float r = 0.0f;
  for (int k = 0; k < n_warps; ++k) r += part[k];
  return r;
}

__global__ void blend_bwd_kernel(
    const float* __restrict__ slab, const int* __restrict__ counts_p,
    const int* __restrict__ tid, const float* __restrict__ final_T,
    const int* __restrict__ ncon, const float* __restrict__ u_r,
    const float* __restrict__ u_g, const float* __restrict__ u_b,
    const float* __restrict__ u_d, const float* __restrict__ u_one,
    const float* __restrict__ bg_term, int cap, int num_tiles, int tile,
    int gx, float* __restrict__ grad) {
  __shared__ float sh[DATA_W][BATCH];
  __shared__ float part[2][GRAD_W][MAX_WARPS];
  __shared__ int walk_sh;
  const int p = blockIdx.x;
  const int sp = threadIdx.x;
  const int lane = sp & 31, warp = sp >> 5;
  const int n_warps = blockDim.x >> 5;
  const int t = tid[p];
  const float px = (float)((t % gx) * tile + sp % tile);
  const float py = (float)((t / gx) * tile + sp / tile);
  const long long o = (long long)sp * num_tiles + p;
  const int my_ncon = ncon[o];
  const float Tf = final_T[o];
  const float ur = u_r[o], ug = u_g[o], ub = u_b[o], ud = u_d[o],
              uone = u_one[o];
  const float tb = -Tf * bg_term[o];

  if (sp == 0) walk_sh = 0;
  __syncthreads();
  atomicMax(&walk_sh, my_ncon);  // integer max: the same result in any order
  __syncthreads();
  const int walk = min(counts_p[p], walk_sh);

  float T = Tf, Sr = 0.0f, Sg = 0.0f, Sb = 0.0f, Sd = 0.0f, S1 = 0.0f;
  int buf = 0;
  for (int top = walk; top > 0; top -= BATCH) {
    const int lo = max(0, top - BATCH);
    const int nb = top - lo;
    // also keeps the previous batch in shared memory until all have read it
    __syncthreads();
    for (int i = sp; i < DATA_W * nb; i += blockDim.x) {
      const int r = i / nb, j = i % nb;
      sh[r][j] = slab[((long long)r * cap + lo + j) * num_tiles + p];
    }
    __syncthreads();
    for (int j = nb - 1; j >= 0; --j) {
      const int s = lo + j;
      const float mx = sh[0][j], my = sh[1][j], ca = sh[2][j], cb = sh[3][j],
                  cc = sh[4][j], op = sh[5][j], de = sh[6][j], cr = sh[7][j],
                  cg = sh[8][j], cbl = sh[9][j];
      const float dx = mx - px;
      const float dy = my - py;
      const float power = -0.5f * (ca * dx * dx + cc * dy * dy) - cb * dx * dy;
      const float G = expf(power);
      const float oG = op * G;
      const float alpha = fminf(ALPHA_MAX, oG);
      const bool blended =
          (power <= 0.0f) && (alpha >= ALPHA_MIN) && (s < my_ncon);
      const float inv1ma = 1.0f / (1.0f - alpha);
      if (blended) T = T * inv1ma;
      const float w = blended ? alpha * T : 0.0f;
      const float Q = ur * Sr + ug * Sg + ub * Sb + ud * Sd + uone * S1;
      float dL_da = T * (ur * cr + ug * cg + ub * cbl + ud * de + uone) +
                    (tb - Q) * inv1ma;
      dL_da = blended ? dL_da : 0.0f;
      Sr = Sr + w * cr;
      Sg = Sg + w * cg;
      Sb = Sb + w * cbl;
      Sd = Sd + w * de;
      S1 = S1 + w;
      const float h = (oG < ALPHA_MAX ? G : 0.0f) * dL_da;
      const float hdx = h * dx;
      const float hdy = h * dy;
      float v[GRAD_W] = {h,       hdx,    hdy,    hdx * dx, hdx * dy,
                         hdy * dy, w * ud, w * ur, w * ug,   w * ub};
#pragma unroll
      for (int c = 0; c < GRAD_W; ++c) {
        v[c] = warp_sum(v[c]);
        if (lane == 0) part[buf][c][warp] = v[c];
      }
      __syncthreads();
      if (sp < GRAD_W) {
        // the channel algebra of blend.py:448-459, one row per thread
        float m[6];
#pragma unroll
        for (int c = 0; c < 6; ++c) m[c] = sum_warps(part[buf][c], n_warps);
        float g;
        if (sp == 0) g = -op * (ca * m[1] + cb * m[2]);        // d mx
        else if (sp == 1) g = -op * (cc * m[2] + cb * m[1]);   // d my
        else if (sp == 2) g = -0.5f * op * m[3];                // d conic a
        else if (sp == 3) g = -op * m[4];                       // d conic b
        else if (sp == 4) g = -0.5f * op * m[5];                // d conic c
        else if (sp == 5) g = m[0];                             // d opacity
        else g = sum_warps(part[buf][sp], n_warps);             // depth, rgb
        grad[((long long)sp * cap + s) * num_tiles + p] = g;
      }
      buf ^= 1;
    }
  }
}

}  // namespace

extern "C" int bs_blend_backward(const float* slab, const int* counts_p,
                                 const int* tid, const float* final_T,
                                 const int* ncon, const float* u_r,
                                 const float* u_g, const float* u_b,
                                 const float* u_d, const float* u_one,
                                 const float* bg_term, int cap, int num_tiles,
                                 int tile, int gx, float* grad, void* stream) {
  if (num_tiles > 0) {
    blend_bwd_kernel<<<num_tiles, tile * tile, 0, (cudaStream_t)stream>>>(
        slab, counts_p, tid, final_T, ncon, u_r, u_g, u_b, u_d, u_one,
        bg_term, cap, num_tiles, tile, gx, grad);
  }
  return (int)cudaGetLastError();
}
