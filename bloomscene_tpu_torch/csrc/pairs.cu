// K3 -- pair expansion: depth-ranked splats -> tile-sort keys and ids.
//
// Replaces the TPU kernel bloomscene_tpu/ops/pallas/pairs.py::_pairs_kernel
// (with _pairs_subblock), called from bloomscene_tpu/ops/tiles.py:347-364.
//
// What it computes, for every pair slot k < pair_capacity:
//   - the owning depth rank r: the last rank with starts[r] <= k (ranks
//     that touch no tile sit at the tail with starts == total, so the live
//     ranks form a gap-free prefix); slots past the total map to the last
//     live rank, as the XLA chain's marker/cummax recovery does;
//   - the tile (tx, ty) from the rank's rectangle and k's offset inside it;
//   - the exact-zero cull: the minimum of the conic quadratic over the
//     tile's pixel box against ln(255 * opacity) + 1e-3, in float32 and in
//     the operation order of tiles.py:448-474, so the keys equal the XLA
//     chain's bit for bit;
//   - key = (tile << kbits) | k when that fits 31 bits (tile = num_tiles
//     for culled or dead slots), else the tile id alone for the two-key
//     sort; id = order[r].
//
// What bounds it on an H100: bytes. Each slot writes 8 bytes and reads one
// rank's row (about 40 bytes, mostly from L2 since neighbouring slots share
// ranks); the arithmetic is ~60 float operations, far under the 67 TFLOP/s
// float32 rate. One thread per slot with a binary search over the starts
// (log2(n) dependent loads) replaces the TPU's bf16 digit split and one-hot
// MXU contraction, which existed only because the TPU cannot gather per
// lane; neighbouring threads hit the same ranks, so the searches share
// cache lines.
//
// Built with --fmad=false: contracting a multiply and an add into one FMA
// would change the cull's rounding and let keys differ from the plain
// version at the margin.
#include <cuda_runtime.h>

namespace {

// NaN-propagating min/max, as jnp.minimum / jnp.maximum and torch.minimum /
// torch.maximum (fminf / fmaxf drop a NaN operand).
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a) ? a : ((b != b) ? b : fminf(a, b));
}
__device__ __forceinline__ float clipf(float v, float lo, float hi) {
  return nan_min(nan_max(v, lo), hi);
}

__device__ __forceinline__ float qq(float ca, float cb, float cc, float dx,
                                    float dy) {
  return 0.5f * (ca * dx * dx + cc * dy * dy) + cb * dx * dy;
}

__global__ void expand_pairs_kernel(
    const int* __restrict__ starts_full, const int* __restrict__ x0,
    const int* __restrict__ y0, const int* __restrict__ w,
    const int* __restrict__ order, const float* __restrict__ atab, int n,
    int pair_capacity, int gx, int tile, int kbits, int num_tiles,
    int packed_key, int cull, int* __restrict__ key_out,
    int* __restrict__ gauss_out) {
  const int k = blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= pair_capacity) return;
  const int total = starts_full[n];
  // last rank with starts[r] <= min(k, total - 1); rank 0 when none
  const int v = min(k, total - 1);
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (starts_full[mid] <= v) lo = mid + 1; else hi = mid;
  }
  const int r = max(lo - 1, 0);

  const int local = k - starts_full[r];
  const int wr = w[r];
  const int q = local / wr;
  const int tx = x0[r] + (local - q * wr);
  const int ty = y0[r] + q;
  bool live = k < total;
  if (live && cull) {
    const float mx = atab[r], my = atab[n + r];
    const float ca = atab[2 * n + r], cb = atab[3 * n + r];
    const float cc = atab[4 * n + r], ln_t = atab[5 * n + r];
    const float ftile = (float)tile;
    const float lox = (float)tx * ftile - mx;
    const float hix = lox + (ftile - 1.0f);
    const float loy = (float)ty * ftile - my;
    const float hiy = loy + (ftile - 1.0f);
    const float ex_lo = qq(ca, cb, cc, lox, clipf(-cb * lox / cc, loy, hiy));
    const float ex_hi = qq(ca, cb, cc, hix, clipf(-cb * hix / cc, loy, hiy));
    const float ey_lo = qq(ca, cb, cc, clipf(-cb * loy / ca, lox, hix), loy);
    const float ey_hi = qq(ca, cb, cc, clipf(-cb * hiy / ca, lox, hix), hiy);
    float qmin = nan_min(nan_min(ex_lo, ex_hi), nan_min(ey_lo, ey_hi));
    const bool inside = (lox <= 0.0f) & (hix >= 0.0f) & (loy <= 0.0f) &
                        (hiy >= 0.0f);
    if (inside) qmin = 0.0f;
    live = qmin <= ln_t + (float)1e-3;
  }
  const int tid = live ? ty * gx + tx : num_tiles;
  key_out[k] = packed_key ? ((tid << kbits) | k) : tid;
  gauss_out[k] = order[r];
}

}  // namespace

extern "C" int bs_expand_pairs(const int* starts_full, const int* x0,
                               const int* y0, const int* w, const int* order,
                               const float* atab, int n, int pair_capacity,
                               int gx, int tile, int kbits, int num_tiles,
                               int packed_key, int cull, int* key_out,
                               int* gauss_out, void* stream) {
  if (pair_capacity > 0) {
    const int threads = 256;
    const int blocks = (pair_capacity + threads - 1) / threads;
    expand_pairs_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        starts_full, x0, y0, w, order, atab, n, pair_capacity, gx, tile,
        kbits, num_tiles, packed_key, cull, key_out, gauss_out);
  }
  return (int)cudaGetLastError();
}
