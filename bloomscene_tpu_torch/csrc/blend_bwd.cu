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
// h dy^2 and w * (u_d, u_r, u_g, u_b); from these the 10 gradient rows of
// that slot: d mx, d my, d conic a, b, c, d opacity, d depth, d r, d g, d b
// (blend.py:448-459). Rows at or past the walk are not written; the
// wrapper hands in a zeroed buffer.
//
// What bounds it on an H100: operations -- each walked (pixel, slot) step
// is ~71 float operations with one exp and one division (chip_smoke.py
// counts them), against ~40 bytes of slab per slot shared by the tile's
// pixels. That bound divides them by 67 TFLOP/s, a rate that counts an FMA
// as two operations; built with --fmad=false every multiply and add issues
// alone, so about half of that rate is reachable here.
//
// What held the first design back (one thread per pixel; per slot ten
// 5-step shuffle trees, a barrier and 10 of 256 threads writing): the
// per-slot reduction. A profile of it (profile_blend.py) had 400 shuffles
// per tile-slot keeping the SM's shuffle unit most of the kernel busy, at
// about a third of the issue slots used. This design:
// - gives each thread two horizontally adjacent pixels: half of every
//   pixel sum is one add in registers, a 16x16 tile is 4 warps, and the
//   two pixels' chains run side by side (dy and c dy^2 are shared);
// - skips a slot for a thread where the power alone proves alpha < 1/255
//   at both its pixels (a threshold per slot, logf(1/255 / op) less a
//   margin, computed as the slot is staged): a pixel that does not blend
//   adds exact zeros and keeps its carries, so the skip changes no bit;
// - reduces the ten per-slot sums across a warp's 32 lanes by recursive
//   halving inside each rolled group of 4 slots: each exchange sends half
//   of a lane's values to its partner and adds the other half, first
//   splitting the ten channels (offset 16), then pairing slots (offsets 8
//   and 4) -- 35 shuffles per warp per 4 slots, against 200 before; four
//   lanes per warp are left holding each (slot, channel) partial;
// - writes the partials to shared memory and walks B = 16 slots per
//   barrier; after it, one thread per (slot, row) adds that row's partials
//   in a fixed order and writes its gradient, while the rest go on;
// - loads the slab rows of batch k + 1 into registers while batch k is
//   walked and stages them with the threshold as 12-float records (three
//   vector loads a slot).
// Every sum has a fixed order, so two runs give the same bits (the only
// atomic is the integer max of n_contrib).
//
// Any tile. From 1 to 32 a block is ceil(tile*tile / 2) threads rounded up
// to whole warps and takes the whole tile. Where tile*tile is a multiple of
// 64 (tiles 8, 16, 24, 32) every lane holds two pixels of one row and the
// kernel is built as above (GENERAL = false). Otherwise (GENERAL = true)
// each pixel takes its own row and dy, and a pixel past the tile's P is
// inactive: it reads no input (n_contrib 0, T 1, cotangents 0), never
// blends, and its terms are set to exact zeros, so the lanes that pad the
// last warp take part in every shuffle and partial sum with zeros only.
// Above 32 (SPLIT = true) a tile is cut as K1 cuts it (csrc/blend.cu):
// S = ceil(P / 1024) blocks of at most 1,024 pixels (512 threads, the
// tile-32 block, 84,736 bytes of shared memory), blockIdx.y taking a
// contiguous range of the tile's pixels. Every block reads the whole
// tile's n_contrib for the walk, so all S walk the same slots. A slot's
// sums span the S blocks, so a block writes its ten per-slot channel sums
// (before the channel algebra) to a scratch buffer [S, 10, cap, T], and a
// second kernel adds the S partials of each (slot, position) in block
// order and applies the algebra. No float atomics: the same bits every
// launch.
//
// A strip of positions (bs_blend_backward_range): the blocks of positions
// [p0, p0 + n) only, reading the slab, counts, ids, K1's residuals and the
// cotangent planes of all T positions in place (stride T) and writing
// [10, cap, n]. A tile's sums read nothing of another tile, so the strip
// is the full call's columns p0 .. p0 + n - 1 bit for bit.
//
// Built with --fmad=false, and every per-pixel expression keeps the order
// of the plain version (ops/cuda/blend.py::blend_backward_plain), so the
// per-pixel values round alike; only the pixel sums' order differs.
#include <cuda_runtime.h>

namespace {

constexpr int DATA_W = 10;
constexpr int GRAD_W = 10;
constexpr int HALF = GRAD_W / 2;   // channels a lane carries after offset 16
constexpr int B = 16;              // slots walked per barrier
constexpr int QUAD = 4;            // slots exchanged within one iteration
constexpr int REC = 12;            // floats per staged slot: the 10 rows,
                                   // skip_below(op) and a pad
constexpr int STAGE = B * REC;     // floats per staged batch
constexpr int PART_STRIDE = B * GRAD_W + 1;  // per partial, padded
constexpr int MAX_THREADS = 512;   // tile 32: 1,024 pixels, two a thread
constexpr int ONE_BLOCK_TILE = 32;  // the largest tile one block takes
constexpr int MAX_LOADS = (DATA_W * B + 31) / 32;  // staging loads a thread
constexpr float ALPHA_MIN = (float)(1.0 / 255.0);
constexpr float ALPHA_MAX = (float)0.99;
constexpr unsigned FULL = 0xffffffffu;

// The power below which op e^power < 1/255 however expf, logf and the
// product round (each within 2 ulp; 1e-3 of margin in the exponent): a
// pixel below it does not blend, so it skips without the exp. +inf for
// op = 0 (every pixel skips).
__device__ __forceinline__ float skip_below(float op) {
  return logf(ALPHA_MIN / op) - 1e-3f;
}

// out[c] = (hi ? b : a)[c] + the (hi ? a : b)[c] of lane ^ off; the lane
// with hi keeps b's half of the work, its partner a's
__device__ __forceinline__ void exchange(float* out, const float* a,
                                         const float* b, int off, bool hi) {
#pragma unroll
  for (int c = 0; c < HALF; ++c) {
    const float send = hi ? a[c] : b[c];
    const float keep = hi ? b[c] : a[c];
    out[c] = keep + __shfl_xor_sync(FULL, send, off);
  }
}

template <bool GENERAL, bool SPLIT>
__global__ void __launch_bounds__(MAX_THREADS) blend_bwd_kernel(
    const float* __restrict__ slab, const int* __restrict__ counts_p,
    const int* __restrict__ tid, const float* __restrict__ final_T,
    const int* __restrict__ ncon, const float* __restrict__ u_r,
    const float* __restrict__ u_g, const float* __restrict__ u_b,
    const float* __restrict__ u_d, const float* __restrict__ u_one,
    const float* __restrict__ bg_term, int cap, int num_tiles, int p0,
    int n_out, int tile, int gx, float* __restrict__ grad,
    float* __restrict__ split_part, int* __restrict__ split_walk) {
  extern __shared__ __align__(16) float dyn[];
  float* stage = dyn;               // [3][B][REC]: batches k-1, k, k+1
  float* part = dyn + 3 * STAGE;    // [2][n_part][PART_STRIDE]
  __shared__ int walk_sh;
  const int col = blockIdx.x;      // the output column, position p0 + col
  const int p = p0 + col;
  const int th = threadIdx.x;
  const int lane = th & 31, warp = th >> 5;
  const int n_threads = blockDim.x;
  const int n_part = (n_threads >> 5) * 4;
  const int t = tid[p];

  // the thread's pixels: sp = 2 th and 2 th + 1 (past the block's first
  // pixel when SPLIT), adjacent columns of one row unless GENERAL; a pixel
  // past the tile's P is inactive
  const int P = tile * tile;
  const int sp0 = (SPLIT ? 2 * n_threads * (int)blockIdx.y : 0) + 2 * th;
  const int sp1 = sp0 + 1;
  const bool act0 = !GENERAL || sp0 < P, act1 = !GENERAL || sp1 < P;
  const float px0 = (float)((t % gx) * tile + sp0 % tile);
  const float py0 = (float)((t / gx) * tile + sp0 / tile);
  const float px1 =
      GENERAL ? (float)((t % gx) * tile + sp1 % tile) : px0 + 1.0f;
  const float py1 = GENERAL ? (float)((t / gx) * tile + sp1 / tile) : py0;
  const long long o0 = (long long)sp0 * num_tiles + p;
  const long long o1 = o0 + num_tiles;
  // an inactive pixel reads nothing: n_contrib 0, T 1, cotangents 0
  auto in = [&](const auto* a, long long o, bool act, auto zero) {
    return act ? a[o] : zero;
  };
  const int nc0 = in(ncon, o0, act0, 0), nc1 = in(ncon, o1, act1, 0);
  float T0 = in(final_T, o0, act0, 1.0f), T1 = in(final_T, o1, act1, 1.0f);
  const float ur0 = in(u_r, o0, act0, 0.0f), ur1 = in(u_r, o1, act1, 0.0f),
              ug0 = in(u_g, o0, act0, 0.0f), ug1 = in(u_g, o1, act1, 0.0f),
              ub0 = in(u_b, o0, act0, 0.0f), ub1 = in(u_b, o1, act1, 0.0f),
              ud0 = in(u_d, o0, act0, 0.0f), ud1 = in(u_d, o1, act1, 0.0f),
              uo0 = in(u_one, o0, act0, 0.0f),
              uo1 = in(u_one, o1, act1, 0.0f);
  const float tb0 = -T0 * in(bg_term, o0, act0, 0.0f),
              tb1 = -T1 * in(bg_term, o1, act1, 0.0f);
  float Sr0 = 0.0f, Sg0 = 0.0f, Sb0 = 0.0f, Sd0 = 0.0f, S10 = 0.0f;
  float Sr1 = 0.0f, Sg1 = 0.0f, Sb1 = 0.0f, Sd1 = 0.0f, S11 = 0.0f;

  if (th == 0) walk_sh = 0;
  __syncthreads();
  if (SPLIT) {
    // the whole tile's n_contrib, so that every block walks the same slots
    int m = 0;
    for (int i = th; i < P; i += n_threads)
      m = max(m, ncon[(long long)i * num_tiles + p]);
    atomicMax(&walk_sh, m);  // integer max: any order
  } else {
    atomicMax(&walk_sh, max(nc0, nc1));  // integer max: any order
  }
  __syncthreads();
  const int walk = min(counts_p[p], walk_sh);
  if (SPLIT && blockIdx.y == 0 && th == 0) split_walk[col] = walk;
  const int n_batch = (walk + B - 1) / B;
  // slot j of batch k is s = walk - 1 - k B - j; s < 0 pads the last batch

  float pre[MAX_LOADS];  // batch k's slab rows on their way to stage[k % 3]
  auto load = [&](int k) {
#pragma unroll
    for (int q = 0; q < MAX_LOADS; ++q) {
      const int i = th + q * n_threads;
      const int r = i / B, s = walk - 1 - k * B - i % B;
      pre[q] = (i < DATA_W * B && s >= 0)
                   ? slab[((long long)r * cap + s) * num_tiles + p]
                   : 0.0f;
    }
  };
  auto store = [&](int k) {
    float* dst = stage + (k % 3) * STAGE;
#pragma unroll
    for (int q = 0; q < MAX_LOADS; ++q) {
      const int i = th + q * n_threads;
      if (i < DATA_W * B) {
        dst[(i % B) * REC + i / B] = pre[q];
        if (i / B == 5) dst[(i % B) * REC + DATA_W] = skip_below(pre[q]);
      }
    }
  };

  // the gradient rows of batch k from its partials, one (slot, row) a
  // thread; each channel's partials added in partial order
  auto epilogue = [&](int k) {
    const float* st = stage + (k % 3) * STAGE;
    const float* pt = part + (k & 1) * n_part * PART_STRIDE;
    for (int o = th; o < B * GRAD_W; o += n_threads) {
      const int j = o / GRAD_W, row = o % GRAD_W;
      const int s = walk - 1 - k * B - j;
      if (s < 0) continue;
      auto msum = [&](int c) {
        float r = 0.0f;
        for (int q = 0; q < n_part; ++q)
          r += pt[q * PART_STRIDE + j * GRAD_W + c];
        return r;
      };
      if (SPLIT) {
        // this block's sum of channel ``row``; split_sums adds the blocks
        split_part[(((long long)blockIdx.y * GRAD_W + row) * cap + s) *
                       n_out + col] = msum(row);
        continue;
      }
      const float* rec = st + j * REC;
      const float ca = rec[2], cb = rec[3], cc = rec[4], op = rec[5];
      float g;
      // the channel algebra of blend.py:448-459
      switch (row) {
        case 0: g = -op * (ca * msum(1) + cb * msum(2)); break;  // d mx
        case 1: g = -op * (cc * msum(2) + cb * msum(1)); break;  // d my
        case 2: g = -0.5f * op * msum(3); break;                 // d conic a
        case 3: g = -op * msum(4); break;                        // d conic b
        case 4: g = -0.5f * op * msum(5); break;                 // d conic c
        case 5: g = msum(0); break;                              // d opacity
        default: g = msum(row); break;                           // depth, rgb
      }
      grad[((long long)row * cap + s) * n_out + col] = g;
    }
  };

  const bool h16 = (lane & 16) != 0;
  if (n_batch > 0) {
    load(0);
    store(0);
  }
  if (n_batch > 1) load(1);
  __syncthreads();
  // one barrier a batch: batch k + 1 is staged and batch k - 1's rows are
  // written while batch k is walked
  for (int k = 0; k <= n_batch; ++k) {
    if (k + 1 < n_batch) {
      store(k + 1);
      if (k + 2 < n_batch) load(k + 2);
    }
    if (k > 0) epilogue(k - 1);
    if (k == n_batch) break;

    const float* st = stage + (k % 3) * STAGE;
    float* pt = part + (k & 1) * n_part * PART_STRIDE;
#pragma unroll 1
    for (int q = 0; q < B; q += QUAD) {
      float pair[HALF], cur[HALF], prev[HALF];
#pragma unroll
      for (int i = 0; i < QUAD; ++i) {
        const int j = q + i;
        const int s = walk - 1 - k * B - j;
        const float4 r0 = *reinterpret_cast<const float4*>(st + j * REC);
        const float4 r1 = *reinterpret_cast<const float4*>(st + j * REC + 4);
        const float4 r2 = *reinterpret_cast<const float4*>(st + j * REC + 8);
        const float mx = r0.x, my = r0.y, ca = r0.z, cb = r0.w, cc = r1.x,
                    op = r1.y, de = r1.z, cr = r1.w, cg = r2.x, cbl = r2.y,
                    below = r2.z;
        const float dy0 = my - py0;
        float dy1 = GENERAL ? my - py1 : dy0;
        const float ccdd0 = cc * dy0 * dy0;
        const float ccdd1 = GENERAL ? cc * dy1 * dy1 : ccdd0;
        const float dx0 = mx - px0;
        float dx1 = mx - px1;
        const float pw0 = -0.5f * (ca * dx0 * dx0 + ccdd0) - cb * dx0 * dy0;
        const float pw1 = -0.5f * (ca * dx1 * dx1 + ccdd1) - cb * dx1 * dy1;
        // act0 is false only where act1 is: such a lane skips the slot
        const bool n0 = act0 && pw0 >= below, n1 = act1 && pw1 >= below;
        float v[GRAD_W];
#pragma unroll
        for (int c = 0; c < GRAD_W; ++c) v[c] = 0.0f;
        // both pixels side by side, each expression the plain version's: a
        // pixel that does not blend gets w = 0 and dL/dalpha = 0, as there;
        // s < 0 (padding) fails the unsigned compare
        if (n0 || n1) {
          const float G0 = expf(pw0), G1 = expf(pw1);
          const float oG0 = op * G0, oG1 = op * G1;
          const float a0 = fminf(ALPHA_MAX, oG0), a1 = fminf(ALPHA_MAX, oG1);
          const bool b0 = n0 && (pw0 <= 0.0f) && (a0 >= ALPHA_MIN) &&
                          ((unsigned)s < (unsigned)nc0);
          const bool b1 = n1 && (pw1 <= 0.0f) && (a1 >= ALPHA_MIN) &&
                          ((unsigned)s < (unsigned)nc1);
          const float i0 = 1.0f / (1.0f - a0), i1 = 1.0f / (1.0f - a1);
          T0 = b0 ? T0 * i0 : T0;
          T1 = b1 ? T1 * i1 : T1;
          const float w0 = b0 ? a0 * T0 : 0.0f, w1 = b1 ? a1 * T1 : 0.0f;
          const float Q0 = ur0 * Sr0 + ug0 * Sg0 + ub0 * Sb0 + ud0 * Sd0 +
                           uo0 * S10;
          const float Q1 = ur1 * Sr1 + ug1 * Sg1 + ub1 * Sb1 + ud1 * Sd1 +
                           uo1 * S11;
          float d0 = T0 * (ur0 * cr + ug0 * cg + ub0 * cbl + ud0 * de + uo0) +
                     (tb0 - Q0) * i0;
          float d1 = T1 * (ur1 * cr + ug1 * cg + ub1 * cbl + ud1 * de + uo1) +
                     (tb1 - Q1) * i1;
          d0 = b0 ? d0 : 0.0f;
          d1 = b1 ? d1 : 0.0f;
          Sr0 = Sr0 + w0 * cr;
          Sr1 = Sr1 + w1 * cr;
          Sg0 = Sg0 + w0 * cg;
          Sg1 = Sg1 + w1 * cg;
          Sb0 = Sb0 + w0 * cbl;
          Sb1 = Sb1 + w1 * cbl;
          Sd0 = Sd0 + w0 * de;
          Sd1 = Sd1 + w1 * de;
          S10 = S10 + w0;
          S11 = S11 + w1;
          const float h0 = (oG0 < ALPHA_MAX ? G0 : 0.0f) * d0;
          float h1 = (oG1 < ALPHA_MAX ? G1 : 0.0f) * d1;
          if (GENERAL && !act1) {
            // exact zeros in every term of the inactive pixel
            h1 = dx1 = dy1 = 0.0f;
          }
          const float hx0 = h0 * dx0, hx1 = h1 * dx1;
          const float hy0 = h0 * dy0, hy1 = h1 * dy1;
          v[0] = h0 + h1;
          v[1] = hx0 + hx1;
          v[2] = hy0 + hy1;
          v[3] = hx0 * dx0 + hx1 * dx1;
          v[4] = hx0 * dy0 + hx1 * dy1;
          v[5] = hy0 * dy0 + hy1 * dy1;
          v[6] = w0 * ud0 + w1 * ud1;
          v[7] = w0 * ur0 + w1 * ur1;
          v[8] = w0 * ug0 + w1 * ug1;
          v[9] = w0 * ub0 + w1 * ub1;
        }
        // halve across the lanes: channels by lane bit 4, then slot i's
        // pair by bit 3 and the quad's two pairs by bit 2
        exchange(cur, v, v + HALF, 16, h16);
        if (i & 1) {
          exchange(cur, prev, cur, 8, (lane & 8) != 0);
          if (i == 1) {
#pragma unroll
            for (int c = 0; c < HALF; ++c) pair[c] = cur[c];
          } else {
            exchange(cur, pair, cur, 4, (lane & 4) != 0);
          }
        } else {
#pragma unroll
          for (int c = 0; c < HALF; ++c) prev[c] = cur[c];
        }
      }
      // lane holds channels 5 bit4 + c of slot q + bit3 + 2 bit2, summed
      // over the 8 lanes that share its bits 0 and 1
      const int jl = q + ((lane >> 3) & 1) + (((lane >> 2) & 1) << 1);
      float* dst = pt + (warp * 4 + (lane & 3)) * PART_STRIDE +
                   jl * GRAD_W + (h16 ? HALF : 0);
#pragma unroll
      for (int c = 0; c < HALF; ++c) dst[c] = cur[c];
    }
    __syncthreads();
  }
}

// A split tile's gradient rows: the ten channel sums of each (slot s,
// output column j) below the walk, each added over the S blocks in block
// order, then the channel algebra of the epilogue above.
__global__ void __launch_bounds__(256) split_sums(
    const float* __restrict__ slab, const float* __restrict__ split_part,
    const int* __restrict__ split_walk, int splits, int cap, int num_tiles,
    int p0, int n_out, float* __restrict__ grad) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)cap * n_out) return;
  const int s = (int)(i / n_out), j = (int)(i % n_out);
  if (s >= split_walk[j]) return;
  const long long plane = (long long)cap * n_out;
  float m[GRAD_W];
#pragma unroll
  for (int c = 0; c < GRAD_W; ++c) {
    float r = 0.0f;
    for (int k = 0; k < splits; ++k)
      r += split_part[((long long)k * GRAD_W + c) * plane + i];
    m[c] = r;
  }
  // the slab's rows of (s, p0 + j), stride num_tiles
  const long long in_plane = (long long)cap * num_tiles;
  const long long si = (long long)s * num_tiles + p0 + j;
  const float ca = slab[2 * in_plane + si], cb = slab[3 * in_plane + si],
              cc = slab[4 * in_plane + si], op = slab[5 * in_plane + si];
  // the channel algebra of blend.py:448-459, as in the epilogue
  const float g[GRAD_W] = {-op * (ca * m[1] + cb * m[2]),
                           -op * (cc * m[2] + cb * m[1]),
                           -0.5f * op * m[3],
                           -op * m[4],
                           -0.5f * op * m[5],
                           m[0], m[6], m[7], m[8], m[9]};
#pragma unroll
  for (int c = 0; c < GRAD_W; ++c) grad[c * plane + i] = g[c];
}

}  // namespace

// Block shape of a tile: threads (whole warps), dynamic shared memory
// bytes and the blocks a tile is split into (K1's cut); nonzero for a tile
// below 1.
extern "C" int bs_blend_backward_shape(int tile, int* threads, int* smem,
                                       int* splits) {
  if (tile < 1 || tile > 46340) return (int)cudaErrorInvalidValue;
  const int P = tile * tile;
  int pb = (P + 63) / 64 * 64;  // two pixels a thread, whole warps
  if (tile > ONE_BLOCK_TILE) {
    const int s = (P + 2 * MAX_THREADS - 1) / (2 * MAX_THREADS);
    pb = ((P + s - 1) / s + 63) / 64 * 64;
  }
  const int n = pb / 2;
  *threads = n;
  *smem = (int)sizeof(float) * (3 * STAGE + 2 * (n / 32) * 4 * PART_STRIDE);
  *splits = (P + pb - 1) / pb;
  return 0;
}

// Positions [p0, p0 + n) of num_tiles into grad [10, cap, n]. split_part
// [S, 10, cap, n] float32 and split_walk [n] int32 are scratch for a tile
// above 32 (S from bs_blend_backward_shape); null otherwise. Nonzero for a
// range outside [0, num_tiles).
extern "C" int bs_blend_backward_range(
    const float* slab, const int* counts_p, const int* tid,
    const float* final_T, const int* ncon, const float* u_r,
    const float* u_g, const float* u_b, const float* u_d, const float* u_one,
    const float* bg_term, int cap, int num_tiles, int p0, int n, int tile,
    int gx, float* grad, void* stream, float* split_part, int* split_walk) {
  int threads, smem, splits;
  const int err = bs_blend_backward_shape(tile, &threads, &smem, &splits);
  if (err) return err;
  if (p0 < 0 || n < 0 || p0 > num_tiles - n)
    return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const int P = tile * tile;
    const bool general = P % (2 * threads) != 0 || tile % 2 != 0;
    const bool split = tile > ONE_BLOCK_TILE;
    const auto kernel =
        split ? (general ? blend_bwd_kernel<true, true>
                         : blend_bwd_kernel<false, true>)
              : (general ? blend_bwd_kernel<true, false>
                         : blend_bwd_kernel<false, false>);
    // a block may take more than 48 KB of dynamic shared memory (84,736
    // bytes at tile 32) only when the kernel is allowed it
    const cudaError_t set = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (set != cudaSuccess) return (int)set;
    kernel<<<dim3(n, splits), threads, smem, (cudaStream_t)stream>>>(
        slab, counts_p, tid, final_T, ncon, u_r, u_g, u_b, u_d, u_one,
        bg_term, cap, num_tiles, p0, n, tile, gx, grad, split_part,
        split_walk);
    if (split && cap > 0) {
      const long long n_sums = (long long)cap * n;
      split_sums<<<(unsigned)((n_sums + 255) / 256), 256, 0,
                   (cudaStream_t)stream>>>(slab, split_part, split_walk,
                                           splits, cap, num_tiles, p0, n,
                                           grad);
    }
  }
  return (int)cudaGetLastError();
}

// Every position: grad [10, cap, num_tiles], split_part [S, 10, cap,
// num_tiles] and split_walk [num_tiles]. The scratch comes last, so a
// caller of the tile-1-32 form (no scratch) still passes the stream where
// it was.
extern "C" int bs_blend_backward(const float* slab, const int* counts_p,
                                 const int* tid, const float* final_T,
                                 const int* ncon, const float* u_r,
                                 const float* u_g, const float* u_b,
                                 const float* u_d, const float* u_one,
                                 const float* bg_term, int cap, int num_tiles,
                                 int tile, int gx, float* grad,
                                 void* stream, float* split_part,
                                 int* split_walk) {
  return bs_blend_backward_range(slab, counts_p, tid, final_T, ncon, u_r,
                                 u_g, u_b, u_d, u_one, bg_term, cap,
                                 num_tiles, 0, num_tiles, tile, gx, grad,
                                 stream, split_part, split_walk);
}
