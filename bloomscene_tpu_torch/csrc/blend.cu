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
// A strip of positions (bs_blend_forward_range): the blocks of positions
// [p0, p0 + n) only, reading the whole [10, cap, T] slab, counts and ids in
// place (stride T) and writing [P, n] planes. A tile's blend reads nothing
// of another tile, so the strip's planes are the full call's columns
// p0 .. p0 + n - 1 bit for bit; the tile-parallel render gives each rank
// of the tile axis its strip (ops/cuda/wrapper.py).
//
// What bounds it on an H100: operations -- each (pixel, splat) step is ~30
// float operations and one exp, against ~40 bytes per splat shared by the
// tile's pixels. That bound divides them by 67 TFLOP/s, a rate that counts
// an FMA as two operations; built with --fmad=false every multiply and add
// issues alone, so about half of that rate is reachable here.
//
// What held the first design back (one thread per pixel, batches of 256
// slots loaded with strided reads between two barriers): a profile of it
// (profile_blend.py) had ~50 instructions issued a step, 6-10 of them
// scalar shared loads, in one dependent chain a warp, at ~63% of the issue
// slots. This design cuts the instructions a step:
// - each thread takes two horizontally adjacent pixels: one broadcast load
//   of a splat serves both, dy and c dy^2 are shared, and the two chains
//   run side by side; a 16x16 tile is 4 warps;
// - each splat is derived once per block into a 12-float record (three
//   vector loads): the -0.5 and the sign of b folded into a, c and b, and
//   a skip threshold, the power below which op e^power < 1/255;
// - a thread whose two pixels are below the threshold goes to the next
//   splat without the exp (two thirds of the steps at the orbit's shapes
//   blend nothing), and the blend itself is branch-free selects;
// - the rows of batch k + 2 are copied with cp.async and batch k + 1 is
//   derived while batch k is blended, one barrier a batch of 64 slots;
// - the block leaves as soon as all its pixels have stopped (the barrier
//   counts them), a thread when both its pixels have.
// Blocks are per tile, so the TPU's 128-tile lane groups, occupancy-sorted
// group maxima and unrolled chains have no counterpart here.
//
// Any tile. From 1 to 32 a block is ceil(tile*tile / 2) threads rounded up
// to whole warps and takes the whole tile. Where tile*tile is a multiple of
// 64 (tiles 8, 16, 24, 32) every lane holds two pixels of one row and the
// kernel is built as above (GENERAL = false). Otherwise (GENERAL = true)
// each pixel takes its own row and dy (at an odd tile a thread's two pixels
// may straddle two rows), and a lane past the tile's pixels starts stopped:
// it stages and derives its share of each batch and meets every barrier,
// but walks no splat and writes nothing.
// Above 32 (SPLIT = true) a tile is cut into S = ceil(P / 1024) blocks of
// PB pixels each (ceil(P / S) rounded up to 64, at most 1,024: 512
// threads), blockIdx.y taking the contiguous pixels [y PB, y PB + PB).
// Pixels are independent in the forward, so each block walks the tile's
// splats for its own pixels only; GENERAL as above where the tile is odd
// or the last block is short.
//
// Bitwise equal to the plain version: built with --fmad=false, and each
// pixel's arithmetic is the plain version's in its order (a contracted FMA
// could move a pixel across the 1e-4 stop or the 1/255 skip). Scaling by
// -0.5 and negating are exact in binary floating point, so the folded
// record gives the same power (short of subnormal intermediates, where
// the power is too small for exp to tell), and the threshold only skips
// pixels that the alpha test would skip.
#include <cuda_runtime.h>

namespace {

constexpr int DATA_W = 10;
constexpr int BATCH = 64;           // slots per staged batch
constexpr int REC = 12;             // floats per derived splat record
constexpr int PIX = 2;              // pixels per thread
constexpr int MAX_THREADS = 512;    // tile 32: 1,024 pixels
constexpr int ONE_BLOCK_TILE = 32;  // the largest tile one block takes
// the JAX package's constants (ops/reference_rasterizer.py), rounded from
// double to float as a float32 comparison with a Python float rounds them
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float ALPHA_MAX = (float)0.99;
constexpr float T_EPS = (float)1e-4;
constexpr float ACC_SEED = (float)1e-6;

// The power below which op e^power < 1/255 however expf, logf and the
// product round (each within 2 ulp; 1e-3 of margin in the exponent): a
// pixel below it fails the alpha skip, so it skips without the exp.
// +inf for op = 0 (every pixel skips); NaN for a negative or NaN op, which
// skips too, as the plain version's alpha test does.
__device__ __forceinline__ float skip_below(float op) {
  return logf(ALPHA_MIN / op) - 1e-3f;
}

// 4 bytes global -> shared without a register; zero-filled when !valid
__device__ __forceinline__ void copy_async(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

template <bool GENERAL, bool SPLIT>
__global__ void __launch_bounds__(MAX_THREADS) blend_fwd_kernel(
    const float* __restrict__ slab, const int* __restrict__ counts_p,
    const int* __restrict__ tid, int cap, int num_tiles, int p0, int n_out,
    int tile, int gx, float* __restrict__ planes, int* __restrict__ ncon_out) {
  __shared__ float raw[2][DATA_W][BATCH];             // cp.async targets
  __shared__ __align__(16) float rec[2][BATCH][REC];  // derived records
  const int col = blockIdx.x;      // the output column, position p0 + col
  const int p = p0 + col;
  const int P = tile * tile;
  const int th = threadIdx.x;
  const int t = tid[p];
  const int cnt = counts_p[p];

  // batch k's rows into raw[k & 1], one 4-byte copy per (row, slot)
  auto issue = [&](int k) {
    for (int i = th; i < DATA_W * BATCH; i += blockDim.x) {
      const int r = i / BATCH, j = i % BATCH, s = k * BATCH + j;
      const bool ok = s < cnt;
      copy_async(&raw[k & 1][r][j],
                 ok ? slab + ((long long)r * cap + s) * num_tiles + p : slab,
                 ok);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  // raw[k & 1] -> rec[k & 1]: {mx, my, skip_below, 0}, {-ca/2, -cc/2, -cb,
  // op}, {depth, r, g, b}, one slot a thread
  auto derive = [&](int k) {
    for (int j = th; j < BATCH; j += blockDim.x) {
      const float(*x)[BATCH] = raw[k & 1];
      float* d = rec[k & 1][j];
      *reinterpret_cast<float4*>(d) =
          make_float4(x[0][j], x[1][j], skip_below(x[5][j]), 0.0f);
      *reinterpret_cast<float4*>(d + 4) =
          make_float4(-0.5f * x[2][j], -0.5f * x[4][j], -x[3][j], x[5][j]);
      *reinterpret_cast<float4*>(d + 8) =
          make_float4(x[6][j], x[7][j], x[8][j], x[9][j]);
    }
  };

  // the thread's pixels: sp = 2 th and 2 th + 1 (past the block's first
  // pixel when SPLIT), adjacent columns of one row unless GENERAL; a pixel
  // past the tile's P is inactive
  const int sp0 = (SPLIT ? PIX * blockDim.x * blockIdx.y : 0) + PIX * th;
  const int sp1 = sp0 + 1;
  const bool act0 = !GENERAL || sp0 < P, act1 = !GENERAL || sp1 < P;
  const float px0 = (float)((t % gx) * tile + sp0 % tile);
  const float py0 = (float)((t / gx) * tile + sp0 / tile);
  const float px1 =
      GENERAL ? (float)((t % gx) * tile + sp1 % tile) : px0 + 1.0f;
  const float py1 = GENERAL ? (float)((t / gx) * tile + sp1 / tile) : py0;
  float T0 = 1.0f, T1 = 1.0f, Cr0 = 0.0f, Cr1 = 0.0f, Cg0 = 0.0f, Cg1 = 0.0f,
        Cb0 = 0.0f, Cb1 = 0.0f, D0 = 0.0f, D1 = 0.0f, acc0 = ACC_SEED,
        acc1 = ACC_SEED;
  int nc0 = 0, nc1 = 0;
  bool live0 = act0, live1 = act1;

  if (cnt > 0) {
    issue(0);
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    derive(0);
    if (BATCH < cnt) issue(1);
  }
  for (int k = 0, base = 0; base < cnt; ++k, base += BATCH) {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    // publishes rec[k & 1] and raw[(k + 1) & 1]; raw[k & 1] and
    // rec[(k + 1) & 1] are free once every thread is past it
    if (__syncthreads_count(live0 || live1) == 0) break;
    if (base + 2 * BATCH < cnt) issue(k + 2);
    if (base + BATCH < cnt) derive(k + 1);
    const float* r = rec[k & 1][0];
    const float* const end = r + min(BATCH, cnt - base) * REC;
    for (int slot = base + 1; r < end && (live0 || live1);
         ++slot, r += REC) {
      const float4 d0 = *reinterpret_cast<const float4*>(r);
      // rows: mx, my, skip_below, 0 | -ca/2, -cc/2, -cb, op |
      // depth, r, g, b
      const float dy0 = d0.y - py0;
      const float dy1 = GENERAL ? d0.y - py1 : dy0;
      const float4 d1 = *reinterpret_cast<const float4*>(r + 4);
      // -0.5 (a dx^2 + c dy^2) - b dx dy with the -0.5 and the sign taken
      // into a, c and b: exact scalings, so the same bits
      const float ccdd0 = d1.y * dy0 * dy0;
      const float ccdd1 = GENERAL ? d1.y * dy1 * dy1 : ccdd0;
      const float dx0 = d0.x - px0;
      const float dx1 = d0.x - px1;
      const float pw0 = (d1.x * dx0 * dx0 + ccdd0) + d1.z * dx0 * dy0;
      const float pw1 = (d1.x * dx1 * dx1 + ccdd1) + d1.z * dx1 * dy1;
      const bool n0 = live0 && pw0 >= d0.z;
      const bool n1 = live1 && pw1 >= d0.z;
      if (!(n0 || n1)) continue;
      const float4 d2 = *reinterpret_cast<const float4*>(r + 8);
      const float a0 = fminf(ALPHA_MAX, d1.w * expf(pw0));
      const float a1 = fminf(ALPHA_MAX, d1.w * expf(pw1));
      const bool ok0 = n0 && pw0 <= 0.0f && a0 >= ALPHA_MIN;
      const bool ok1 = n1 && pw1 <= 0.0f && a1 >= ALPHA_MIN;
      const float t0 = T0 * (1.0f - a0);
      const float t1 = T1 * (1.0f - a1);
      const bool s0 = ok0 && t0 < T_EPS, s1 = ok1 && t1 < T_EPS;
      const bool b0 = ok0 && !s0, b1 = ok1 && !s1;
      live0 = live0 && !s0;
      live1 = live1 && !s1;
      const float w0 = b0 ? a0 * T0 : 0.0f;
      const float w1 = b1 ? a1 * T1 : 0.0f;
      Cr0 = Cr0 + w0 * d2.y;
      Cr1 = Cr1 + w1 * d2.y;
      Cg0 = Cg0 + w0 * d2.z;
      Cg1 = Cg1 + w1 * d2.z;
      Cb0 = Cb0 + w0 * d2.w;
      Cb1 = Cb1 + w1 * d2.w;
      D0 = D0 + w0 * d2.x;
      D1 = D1 + w1 * d2.x;
      acc0 = acc0 + w0;
      acc1 = acc1 + w1;
      T0 = b0 ? t0 : T0;
      T1 = b1 ? t1 : T1;
      nc0 = b0 ? slot : nc0;
      nc1 = b1 ? slot : nc1;
    }
  }
  const long long plane = (long long)P * n_out;
  const float out[2][6] = {{Cr0, Cg0, Cb0, D0, acc0, T0},
                           {Cr1, Cg1, Cb1, D1, acc1, T1}};
  const int ncs[2] = {nc0, nc1};
  const bool act[2] = {act0, act1};
#pragma unroll
  for (int e = 0; e < PIX; ++e) {
    if (!act[e]) continue;
    const long long o = (long long)(sp0 + e) * n_out + col;
#pragma unroll
    for (int c = 0; c < 6; ++c) planes[c * plane + o] = out[e][c];
    ncon_out[o] = ncs[e];
  }
}

}  // namespace

// Block shape of a tile: threads (whole warps), dynamic shared memory
// bytes (none: the buffers are static) and the blocks a tile is split
// into; nonzero for a tile below 1.
extern "C" int bs_blend_forward_shape(int tile, int* threads, int* smem,
                                      int* splits) {
  if (tile < 1 || tile > 46340) return (int)cudaErrorInvalidValue;
  const int P = tile * tile;
  int pb = (P + PIX * 32 - 1) / (PIX * 32) * (PIX * 32);  // whole warps
  if (tile > ONE_BLOCK_TILE) {
    const int s = (P + PIX * MAX_THREADS - 1) / (PIX * MAX_THREADS);
    pb = ((P + s - 1) / s + PIX * 32 - 1) / (PIX * 32) * (PIX * 32);
  }
  *threads = pb / PIX;
  *smem = 0;
  *splits = (P + pb - 1) / pb;
  return 0;
}

// Positions [p0, p0 + n) of a slab of num_tiles positions into [P, n]
// planes; nonzero for a range outside [0, num_tiles).
extern "C" int bs_blend_forward_range(const float* slab, const int* counts_p,
                                      const int* tid, int cap, int num_tiles,
                                      int p0, int n, int tile, int gx,
                                      float* planes, int* ncon_out,
                                      void* stream) {
  int threads, smem, splits;
  const int err = bs_blend_forward_shape(tile, &threads, &smem, &splits);
  if (err) return err;
  if (p0 < 0 || n < 0 || p0 > num_tiles - n)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int P = tile * tile;
    const bool general = P % (PIX * threads) != 0 || tile % 2 != 0;
    const auto kernel =
        tile > ONE_BLOCK_TILE
            ? (general ? blend_fwd_kernel<true, true>
                       : blend_fwd_kernel<false, true>)
            : (general ? blend_fwd_kernel<true, false>
                       : blend_fwd_kernel<false, false>);
    kernel<<<dim3(n, splits), threads, smem, (cudaStream_t)stream>>>(
        slab, counts_p, tid, cap, num_tiles, p0, n, tile, gx, planes,
        ncon_out);
  }
  return (int)cudaGetLastError();
}

// Every position: [P, num_tiles] planes.
extern "C" int bs_blend_forward(const float* slab, const int* counts_p,
                                const int* tid, int cap, int num_tiles,
                                int tile, int gx, float* planes,
                                int* ncon_out, void* stream) {
  return bs_blend_forward_range(slab, counts_p, tid, cap, num_tiles, 0,
                                num_tiles, tile, gx, planes, ncon_out,
                                stream);
}
