// hashgrid_encode -- the multi-resolution hash-grid encoder (HAC's mixed
// 3-D + three 2-D planes), forward and backward, one launch each.
//
// No TPU kernel is replaced: the JAX package's encoder is plain jnp
// (bloomscene_tpu/ops/hashgrid.py, grid_encode and mix_encode) that XLA
// fuses inside the jitted step. In eager torch the same encoder is some
// twenty small ops a level and corner (the port's plain version,
// ops/hashgrid.py::mix_encode_plain), ~13K launches a phase-2 step with
// autograd's backward, and an index_select of every corner.
//
// What it computes. x [N, 3] float32; T <= 4 tables [n_params, F] float32
// (the encoders' binarized tables; F = 4, HAC's features a level, one
// 16-byte row); a list of levels, each with its
// encoder, dimension d (2 or 3), the columns of x it reads, resolution R,
// table size S and offset, and whether it is indexed dense (R^d <= S) or
// hashed. For each row and level, as the plain version does, in its float32
// operations and its order:
//   pos = x * (R - 2) + 0.5, frac = pos - floor(pos);
//   for each corner k (bit j of k: the upper neighbour in dimension j):
//     w = (1 * f_0) * f_1 ... with f_j = frac_j or 1 - frac_j,
//     coordinate floor(pos) or min(floor(pos) + 1, R - 1), excluded (w 0)
//     on the ring (a coordinate 0 or R - 1), clamped to [0, R - 1], the
//     dense row-major index or the XOR-prime hash in uint32, % S + offset;
//     acc = acc + w v, wn = wn + w (v the corner's F features);
//   out = acc / (wn + 1e-9), 0 where a coordinate the encoder reads lies
//   outside [0, 1].
// The build has --fmad=false and the code uses the _rn intrinsics, so no
// multiply and add are contracted: the output is bitwise the plain one.
//
// The backward, given g = d loss / d out [N, L F], writes
// - rows [sum_levels 2^d N, F] and idx (int64): the cotangent of each corner
//   gather, where(in_bounds, g, 0) / (wn + 1e-9) * w, laid out as the plain
//   version's gather takes them (each encoder's levels, then corners, then
//   rows), bitwise the rows autograd gives that gather (its ops, its order);
//   hashgrid_bwd sums them into the tables;
// - dx [N, 3]: the gradient through the corner weights. Autograd's chain:
//   gw_k = where(ring, 0, sum_f(ga_f v_kf) + sum_f(-g_f ((acc_f / den) /
//   den))), ga = g / den; down the product of the weights (d f_j = gw
//   times the product of the factors before j, then gw times f_j), each
//   corner's terms into frac, then times (R - 2) into x. The sums run in
//   the order autograd's engine accumulates them (a later-created node
//   first): a level's corners from the last to the first; the encoders
//   from the last (yz) to the first (xyz); a 2-D plane's levels from the
//   last to the first into its own sum, which then goes into dx; the 3-D
//   encoder's levels from the last to the first straight into dx. Each sum
//   over the F features of a corner takes the order of torch's CUDA
//   reduction of F contiguous floats (F lanes, shuffles at offsets F/2,
//   ..., 1). ops/hashgrid.py::mix_encode_backward_plain is the torch twin.
// The corners are recomputed, not saved: the tables (~7 MB for the
// default encoders) sit in L2, and a saved corner set would be ~0.5 GB.
//
// What bounds it on an H100: bytes. The forward reads x and writes out
// (4 (3 + L F) bytes a row); its corner reads (16 bytes each, 20.05M at
// the full scene's 139,264 rows) come from L2 and L1. The backward reads
// x and g and writes the rows, their indices and dx: 12 + 4 L F + 2^d
// (4 F + 8) a level, 20.05M rows of 24 bytes a full-scale step.
//
// The mapping. The forward takes a block a tile of FWD_ROWS consecutive
// rows, a warp a level at a time and a lane a row (encode_fwd), in 32-bit
// index arithmetic. The backward takes a thread a row and walks
// its levels in the order of the sums above, so dx is summed in one
// thread in a fixed order with no second pass; a warp's threads are
// consecutive rows, so each corner's rows are written contiguously.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEVELS = 32;
constexpr int MAX_TABLES = 4;
constexpr int LEVEL_INTS = 12;     // ints a level in the host's list
constexpr int THREADS = 128;       // the backward's block
constexpr int F = 4;               // features a level (HAC's), one float4
constexpr int FWD_ROWS = 32;       // the forward's rows a block (the lanes)
constexpr int FWD_WARPS = 6;       // the forward's warps a block
constexpr int FWD_PAD = 4;         // floats after a staged row (no bank
                                   // conflicts between the lanes' rows)
constexpr int FWD_BLOCKS = 4;      // the forward's blocks an SM, at least:
                                   // left to itself ptxas kept six and
                                   // spilled

// the hash's prime of dimension d
__device__ __forceinline__ unsigned prime(int d) {
  return d == 0 ? 1u : (d == 1 ? 2654435761u : 805459861u);
}

struct Level {
  int dim;          // 2 or 3
  int res;          // R
  int size;         // S, this level's rows in its table
  int offset;       // its first row in the table
  int dense;        // 1: row-major index, 0: hashed
  int enc;          // encoder, and table
  int col[3];       // the columns of x it reads
  int out_col;      // its first column in a row of out
  int corner_base;  // its first corner's block of N rows in rows/idx
  int direct;       // 1: the encoder reads x itself (dx takes each level)
};

struct Spec {
  const float* table[MAX_TABLES];
  Level lv[MAX_LEVELS];
  int n_levels;
  int out_dim;
};

// a row of F floats in one 16-byte load or store
__device__ __forceinline__ void load_row(const float* __restrict__ p,
                                         float (&v)[F]) {
  const float4 q = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}

__device__ __forceinline__ void store_row(float* __restrict__ p,
                                          const float (&v)[F]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// torch's CUDA sum of F contiguous floats: one lane each, then shuffles
// down at offsets F/2, ..., 1, so (t0 + t2) + (t1 + t3)
__device__ __forceinline__ float feature_sum(float (&t)[F]) {
  return __fadd_rn(__fadd_rn(t[0], t[2]), __fadd_rn(t[1], t[3]));
}

// the encoder's input of row n, and whether it lies in [0, 1]^D
template <int D>
__device__ __forceinline__ bool encoder_input(const Level& L,
                                              const float* __restrict__ xr,
                                              float (&xe)[D]) {
  bool inb = true;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    xe[d] = xr[L.col[d]];
    inb = inb && xe[d] >= 0.0f && xe[d] <= 1.0f;
  }
  return inb;
}

template <int D>
__device__ __forceinline__ void position(const Level& L, const float (&xe)[D],
                                         float (&frac)[D],
                                         long long (&p0)[D]) {
  const float s = (float)(L.res - 2);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float pos = __fadd_rn(__fmul_rn(xe[d], s), 0.5f);
    const float fl = floorf(pos);
    frac[d] = __fsub_rn(pos, fl);
    p0[d] = (long long)fl;
  }
}

// corner k's weight, whether it lies on the ring, and its row in the table
template <int D>
__device__ __forceinline__ float corner(const Level& L, const float (&frac)[D],
                                        const long long (&p0)[D], int k,
                                        bool& ring, unsigned& cell) {
  const long long top = L.res - 1;
  float w = 1.0f;
  unsigned c = 0, stride = 1;
  ring = false;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    long long q;
    if ((k >> d) & 1) {
      w = __fmul_rn(w, frac[d]);
      // int64 wraparound, as torch's pos0 + 1
      const long long up = (long long)((unsigned long long)p0[d] + 1ull);
      q = up < top ? up : top;
    } else {
      w = __fmul_rn(w, __fsub_rn(1.0f, frac[d]));
      q = p0[d];
    }
    ring = ring || q == 0 || q == top;
    const unsigned qc = (unsigned)(q < 0 ? 0 : (q > top ? top : q));
    if (L.dense) {
      c += qc * stride;
      stride *= (unsigned)L.res;
    } else {
      c ^= qc * prime(d);
    }
  }
  cell = c % (unsigned)L.size + (unsigned)L.offset;
  return w;
}

// one level of row n's backward: its corners' rows and cells, and its
// gradient to the encoder's input, gx[0..D)
template <int D>
__device__ __forceinline__ void level_bwd(const Level& L,
                                          const float* __restrict__ table,
                                          const float* __restrict__ xr,
                                          const float* __restrict__ gr,
                                          long long N, long long n,
                                          float* __restrict__ rows,
                                          long long* __restrict__ idx,
                                          float (&gx)[3]) {
  constexpr int C = 1 << D;
  float xe[D], frac[D];
  long long p0[D];
  const bool inb = encoder_input<D>(L, xr, xe);
  position<D>(L, xe, frac, p0);
  float v[C][F], wv[C], acc[F], wn = 0.0f;
  unsigned cell[C];
  bool ring[C];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const float w = corner<D>(L, frac, p0, k, ring[k], cell[k]);
    wv[k] = ring[k] ? 0.0f : w;
    load_row(table + (size_t)cell[k] * F, v[k]);
#pragma unroll
    for (int f = 0; f < F; ++f)
      acc[f] = __fadd_rn(acc[f], __fmul_rn(wv[k], v[k][f]));
    wn = __fadd_rn(wn, wv[k]);
  }
  float gl[F];
  if (inb) {
    load_row(gr + L.out_col, gl);
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) gl[f] = 0.0f;
  }
  const float den = __fadd_rn(wn, 1e-9f);
  float ga[F], t[F];
#pragma unroll
  for (int f = 0; f < F; ++f) {
    ga[f] = __fdiv_rn(gl[f], den);
    t[f] = __fmul_rn(-gl[f], __fdiv_rn(__fdiv_rn(acc[f], den), den));
  }
  const float g_den = feature_sum(t);
#pragma unroll
  for (int k = 0; k < C; ++k) {
    const size_t at = (size_t)(L.corner_base + k) * N + n;
    float r[F];
#pragma unroll
    for (int f = 0; f < F; ++f) r[f] = __fmul_rn(ga[f], wv[k]);
    store_row(rows + at * F, r);
    idx[at] = (long long)cell[k];
  }
  float gfrac[D];
#pragma unroll
  for (int k = C - 1; k >= 0; --k) {
    float s[F];
#pragma unroll
    for (int f = 0; f < F; ++f) s[f] = __fmul_rn(ga[f], v[k][f]);
    const float sum = __fadd_rn(feature_sum(s), g_den);
    float gw = ring[k] ? 0.0f : sum;
    // the weight's factors and the products before each, from 1
    float fk[D], before[D], prod = 1.0f;
#pragma unroll
    for (int d = 0; d < D; ++d) {
      fk[d] = ((k >> d) & 1) ? frac[d] : __fsub_rn(1.0f, frac[d]);
      before[d] = prod;
      prod = __fmul_rn(prod, fk[d]);
    }
#pragma unroll
    for (int d = D - 1; d >= 0; --d) {
      const float gf = __fmul_rn(gw, before[d]);
      gw = __fmul_rn(gw, fk[d]);
      const float term = ((k >> d) & 1) ? gf : -gf;
      gfrac[d] = k == C - 1 ? term : __fadd_rn(gfrac[d], term);
    }
  }
  const float s = (float)(L.res - 2);
#pragma unroll
  for (int d = 0; d < D; ++d) gx[d] = __fmul_rn(gfrac[d], s);
}

// the forward's 32-bit position: floor(pos) clamped to [-1, R] before
// the conversion (for x in [0, 1] it lies in [0, R - 2] and the clamp
// changes nothing; elsewhere the output is 0 and the clamp keeps every
// corner's row a row of the table)
template <int D>
__device__ __forceinline__ void position32(int res, const float (&xe)[D],
                                           float (&frac)[D], int (&p0)[D]) {
  const float s = (float)(res - 2);
#pragma unroll
  for (int d = 0; d < D; ++d) {
    const float pos = __fadd_rn(__fmul_rn(xe[d], s), 0.5f);
    const float fl = floorf(pos);
    frac[d] = __fsub_rn(pos, fl);
    p0[d] = (int)fminf(fmaxf(fl, -1.0f), (float)res);
  }
}

// corner k's weight and row as corner() computes them, in 32 bits: the
// dense index needs no modulo (it is below R^d <= S), a power-of-two S a
// mask
template <int D>
__device__ __forceinline__ float corner32(int res, int size, int offset,
                                          bool dense,
                                          const float (&frac)[D],
                                          const int (&p0)[D], int k,
                                          unsigned& cell) {
  const int top = res - 1;
  float w = 1.0f;
  unsigned c = 0, stride = 1;
  bool ring = false;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    int q;
    if ((k >> d) & 1) {
      w = __fmul_rn(w, frac[d]);
      q = min(p0[d] + 1, top);
    } else {
      w = __fmul_rn(w, __fsub_rn(1.0f, frac[d]));
      q = p0[d];
    }
    ring = ring || q == 0 || q == top;
    const unsigned qc = (unsigned)min(max(q, 0), top);
    if (dense) {
      c += qc * stride;
      stride *= (unsigned)res;
    } else {
      c ^= qc * prime(d);
    }
  }
  if (!dense)
    c = (size & (size - 1)) == 0 ? c & (unsigned)(size - 1)
                                 : c % (unsigned)size;
  cell = c + (unsigned)offset;
  return ring ? 0.0f : w;
}

// one level of one row, the plain version's operations in its order (the
// corners' rows loaded first, then added from corner 0 up): the weighted
// sum, and in den its divisor (the division is left to the store, outside
// the level loop: __fdiv_rn's slow path is a call, and registers live
// across it spilled)
template <int D>
__device__ __forceinline__ float4 level_fwd32(const Level& L,
                                              const float* __restrict__ table,
                                              const float* xr, float& den) {
  constexpr int NC = 1 << D;
  const int res = L.res, size = L.size, offset = L.offset;
  const bool dense = L.dense != 0;
  float xe[D], frac[D];
  int p0[D];
  bool inb = true;
#pragma unroll
  for (int d = 0; d < D; ++d) {
    xe[d] = xr[L.col[d]];
    inb = inb && xe[d] >= 0.0f && xe[d] <= 1.0f;
  }
  position32<D>(res, xe, frac, p0);
  float wv[NC];
  float4 v[NC];
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    unsigned cell;
    wv[k] = corner32<D>(res, size, offset, dense, frac, p0, k, cell);
    v[k] = __ldg(reinterpret_cast<const float4*>(table) + cell);
  }
  float acc[F] = {0.0f, 0.0f, 0.0f, 0.0f}, wn = 0.0f;
#pragma unroll
  for (int k = 0; k < NC; ++k) {
    acc[0] = __fadd_rn(acc[0], __fmul_rn(wv[k], v[k].x));
    acc[1] = __fadd_rn(acc[1], __fmul_rn(wv[k], v[k].y));
    acc[2] = __fadd_rn(acc[2], __fmul_rn(wv[k], v[k].z));
    acc[3] = __fadd_rn(acc[3], __fmul_rn(wv[k], v[k].w));
    wn = __fadd_rn(wn, wv[k]);
  }
  // the divisor, or -1 where the output is 0 (wn + 1e-9 is positive)
  den = inb ? __fadd_rn(wn, 1e-9f) : -1.0f;
  return make_float4(acc[0], acc[1], acc[2], acc[3]);
}

// a block: FWD_ROWS consecutive rows, every level. Warp w takes levels w,
// w + FWD_WARPS, ... (with 24 levels, 12 3-D then 12 2-D, each warp two
// of each), a lane a row, so the level is the warp's own: its descriptor
// is read once for the warp, 3-D and 2-D never share a warp, and
// neighbouring rows' corners meet in L1. The rows' features are staged in
// shared memory and written in coalesced 16-byte stores.
__global__ void __launch_bounds__(FWD_WARPS * 32, FWD_BLOCKS)
    encode_fwd(const float* __restrict__ x, int N,
               const __grid_constant__ Spec S, float* __restrict__ out) {
  __shared__ float s_x[FWD_ROWS * 3];
  __shared__ __align__(16) float s_out[FWD_ROWS * (MAX_LEVELS * F + FWD_PAD)];
  __shared__ float s_den[FWD_ROWS * MAX_LEVELS];
  const int row0 = blockIdx.x * FWD_ROWS;
  const int rows = min(FWD_ROWS, N - row0);
  const int stride = S.out_dim + FWD_PAD;
  for (int i = threadIdx.x; i < rows * 3; i += blockDim.x)
    s_x[i] = x[(size_t)row0 * 3 + i];
  __syncthreads();
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane < rows) {
    const float* xr = s_x + 3 * lane;
    float* o = s_out + lane * stride;
    for (int l = warp; l < S.n_levels; l += FWD_WARPS) {
      const Level& L = S.lv[l];
      const float* table = S.table[L.enc];
      float den;
      const float4 r = L.dim == 3 ? level_fwd32<3>(L, table, xr, den)
                                  : level_fwd32<2>(L, table, xr, den);
      *reinterpret_cast<float4*>(o + L.out_col) = r;
      s_den[l * FWD_ROWS + lane] = den;
    }
  }
  __syncthreads();
  const int per_row = S.out_dim / F;
  float4* dst = reinterpret_cast<float4*>(out + (size_t)row0 * S.out_dim);
  for (int q = threadIdx.x; q < rows * per_row; q += blockDim.x) {
    const int r = q / per_row, c = q - r * per_row;
    const float4 a = *reinterpret_cast<const float4*>(s_out + r * stride +
                                                      F * c);
    const float den = s_den[c * FWD_ROWS + r];
    dst[q] = den < 0.0f ? make_float4(0.0f, 0.0f, 0.0f, 0.0f)
                        : make_float4(__fdiv_rn(a.x, den), __fdiv_rn(a.y, den),
                                      __fdiv_rn(a.z, den),
                                      __fdiv_rn(a.w, den));
  }
}

// dx[j] += gx[d] for each column j = L.col[d] the level reads
__device__ __forceinline__ void add_columns(const Level& L,
                                            const float (&gx)[3],
                                            float (&dx)[3]) {
#pragma unroll
  for (int j = 0; j < 3; ++j) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      if (d < L.dim && L.col[d] == j) dx[j] = __fadd_rn(dx[j], gx[d]);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    encode_bwd(const float* __restrict__ x, long long N,
               const __grid_constant__ Spec S, const float* __restrict__ g,
               float* __restrict__ rows, long long* __restrict__ idx,
               float* __restrict__ dx) {
  const long long n = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (n >= N) return;
  const float* xr = x + 3 * n;
  const float* gr = g + n * S.out_dim;
  float dxs[3] = {0.0f, 0.0f, 0.0f}, tot[3] = {0.0f, 0.0f, 0.0f};
  int open = -1;     // the level whose encoder's sum is open
  for (int l = S.n_levels - 1; l >= 0; --l) {
    const Level& L = S.lv[l];
    const bool first = open < 0 || S.lv[open].enc != L.enc;
    if (first && open >= 0 && !S.lv[open].direct)
      add_columns(S.lv[open], tot, dxs);
    float gx[3] = {0.0f, 0.0f, 0.0f};
    if (L.dim == 3)
      level_bwd<3>(L, S.table[L.enc], xr, gr, N, n, rows, idx, gx);
    else
      level_bwd<2>(L, S.table[L.enc], xr, gr, N, n, rows, idx, gx);
    if (L.direct) {
      add_columns(L, gx, dxs);
    } else {
#pragma unroll
      for (int d = 0; d < 3; ++d)
        tot[d] = first ? gx[d] : __fadd_rn(tot[d], gx[d]);
    }
    open = l;
  }
  if (open >= 0 && !S.lv[open].direct) add_columns(S.lv[open], tot, dxs);
#pragma unroll
  for (int j = 0; j < 3; ++j) dx[3 * n + j] = dxs[j];
}

int make_spec(const float* const* tables, int n_tables, const int* levels,
              int n_levels, int features, Spec& S) {
  if (n_tables < 1 || n_tables > MAX_TABLES || n_levels < 1 ||
      n_levels > MAX_LEVELS || features != F)
    return (int)cudaErrorInvalidValue;
  for (int t = 0; t < n_tables; ++t) S.table[t] = tables[t];
  for (int t = n_tables; t < MAX_TABLES; ++t) S.table[t] = nullptr;
  S.n_levels = n_levels;
  S.out_dim = n_levels * F;
  for (int l = 0; l < n_levels; ++l) {
    const int* p = levels + LEVEL_INTS * l;
    Level& L = S.lv[l];
    L.dim = p[0]; L.res = p[1]; L.size = p[2]; L.offset = p[3];
    L.dense = p[4]; L.enc = p[5];
    L.col[0] = p[6]; L.col[1] = p[7]; L.col[2] = p[8];
    L.out_col = p[9]; L.corner_base = p[10]; L.direct = p[11];
    if ((L.dim != 2 && L.dim != 3) || L.res < 2 || L.size < 1 ||
        L.offset < 0 || L.enc < 0 || L.enc >= n_tables || L.out_col != l * F)
      return (int)cudaErrorInvalidValue;
  }
  return 0;
}

}  // namespace

// x [N, 3] float32; tables: n_tables device pointers to [n_params, F]
// float32 tables (16-byte aligned); levels: n_levels x 12 host ints (dim,
// R, size, offset, dense, encoder, three columns, first output column,
// first corner block, direct); features must be F; out [N, n_levels F]
// float32.
extern "C" int bs_hashgrid_encode(const float* x, long long N,
                                  const float* const* tables, int n_tables,
                                  const int* levels, int n_levels,
                                  int features, float* out, void* stream) {
  Spec S;
  const int err = make_spec(tables, n_tables, levels, n_levels, features, S);
  if (err != 0 || N < 0) return err != 0 ? err : (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  if (N >= (1LL << 31)) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((N + FWD_ROWS - 1) / FWD_ROWS);
  encode_fwd<<<blocks, FWD_WARPS * 32, 0, (cudaStream_t)stream>>>(
      x, (int)N, S, out);
  return (int)cudaGetLastError();
}

// as bs_hashgrid_encode, with g [N, n_levels F] float32 the output's
// cotangent; writes rows [sum 2^dim N, F] float32, idx [sum 2^dim N] int64
// and dx [N, 3] float32
extern "C" int bs_hashgrid_encode_bwd(const float* x, long long N,
                                      const float* const* tables,
                                      int n_tables, const int* levels,
                                      int n_levels, int features,
                                      const float* g, float* rows,
                                      long long* idx, float* dx,
                                      void* stream) {
  Spec S;
  const int err = make_spec(tables, n_tables, levels, n_levels, features, S);
  if (err != 0 || N < 0) return err != 0 ? err : (int)cudaErrorInvalidValue;
  if (N == 0) return 0;
  const unsigned blocks = (unsigned)((N + THREADS - 1) / THREADS);
  encode_bwd<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(x, N, S, g, rows,
                                                           idx, dx);
  return (int)cudaGetLastError();
}
