// gather_rows_bwd -- a fixed-order segmented sum over a sorted index: the
// backward of the compacted decode's row gather, and the densify
// statistics' scatter onto their full-capacity tables.
//
// No TPU kernel is replaced: the JAX package gathers the visible anchors'
// rows with jnp indexing (bloomscene_tpu/models/anchors.py, gather_rows),
// and XLA's scatter-add is its transpose; its statistics add with
// .at[].add (bloomscene_tpu/models/densify.py, accumulate_stats). On the
// card, torch's backward of ``x[idx]`` (index_put_ with accumulate) sorts
// the entries and walks each run of one row serially, and index_add_ adds
// with atomics; compact_visible pads its bucket with row C - 1, so one run
// holds most of the entries.
//
// What it computes, for each of up to MAX_LEAVES leaves j with values
// g_j [V, k_j]: out_j [C, k_j], out_j[r] = init_j[r] + the sum of g_j[i]
// over idx[i] == r, where init_j is 0 (the gather's backward) or a base
// table base_j [C, k_j] (index_add's semantics, the statistics); rows no
// entry names are init_j[r].
// The precondition: idx is nondecreasing and in [0, C) (compact_visible's
// index is by construction); the kernel does not check it.
//
// What bounds it on an H100: bytes -- each entry's index (8 bytes) and
// K = sum k_j floats read once, each output row written once (and each
// base row read once); one add an entry and column.
//
// The order, fixed by the entries' positions and the widths alone (no
// atomics, the same bits from one launch to the next). The entries are cut
// into pieces of PIECE. A run of one row that lies inside one piece is
// added in entry order onto init (index_add's sequential order). A run
// that crosses pieces is cut into fragments, one a piece; each fragment is
// added in entry order from 0; the fragments, in order, are cut into
// SHARES contiguous shares, each added from 0, the shares added in order
// from 0, and that total added onto init.
//
// The design: no memset, few dependent rounds of loads a block (with the
// memory busy a round costs microseconds), and the rows' writes beside
// the pieces' reads. Three kernels: row_sums on a side stream (forked
// from the caller's and joined back, so a CUDA graph captures both),
// beside piece_sums and then run_sums on the caller's stream.
// - row_sums: a block owns ROWS output rows. A warp-wide search of idx
//   finds their entries' bounds, the first WINDOW of those entries are
//   staged in shared memory (each row's first entry is found there, unless
//   a long run before it pushes it past). It writes init to every float
//   of its rows that no crossing run names, in coalesced 16-byte stores,
//   then init plus the run, in entry order, to the rows whose run lies in
//   one piece. A crossing run's row is run_sums'.
// - piece_sums: a block takes one piece, or as many as CHUNK_BYTES of
//   rows hold (so narrow leaves such as the statistics' fill a block with
//   (piece, column) pairs as the gather's 99 columns do), a thread a pair.
//   It stages their index in shared memory and finds each piece's
//   fragments: of the run that comes from the piece before (slot 0) and
//   of the run that goes on into the next (slot 1). Where there is one,
//   the pieces' rows pass through shared memory in chunks of CHUNK_BYTES,
//   copied with 16-byte asynchronous copies, the next chunk's in flight
//   while each thread adds its column of this one (a thread a column
//   reading the rows in global memory takes a load instruction a float),
//   and the fragments' sums go to the workspace. Where a crossing run
//   starts, it finds the run's end (a warp-wide search of idx).
// - run_sums: a block takes 32 pieces and RUN_COLS columns: for each
//   crossing run that starts in them it adds the run's fragments in
//   shares and writes the run's row.
// Where all of a run's entries but one are zeros (the padding's are), any
// order gives init + that entry: index_add_'s bits, atomic or sequential.
#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEAVES = 8;
constexpr int PIECE = 128;        // entries a piece
constexpr int THREADS = 256;      // every kernel
constexpr int MAX_GROUP = 8;      // pieces a piece_sums block
constexpr int CHUNK_BYTES = 24 * 1024;  // rows a piece_sums buffer holds
constexpr int MAX_K = 256;        // columns (a thread a (piece, column))
constexpr int ROWS = 128;         // output rows a row block writes
constexpr int WINDOW = 512;       // a row block's entries staged
constexpr int SHARES = 32;        // shares of a crossing run's fragments
constexpr int RUN_COLS = THREADS / SHARES;  // columns a run block
constexpr unsigned FULL = 0xffffffffu;

// the leaves as one space of K columns
struct Leaves {
  const float* g[MAX_LEAVES];     // [V, k] values
  const float* base[MAX_LEAVES];  // [C, k] or null (init 0)
  float* out[MAX_LEAVES];         // [C, k]
  int k[MAX_LEAVES];
  int col0[MAX_LEAVES + 1];       // first column of each leaf; col0[n] = K
  int n;
};

// the workspace: two partial rows of K floats a piece, then (int64) each
// piece's crossing run's end (-1 where none starts in it)
struct Work {
  float* part;
  long long* run_end;
};

__device__ __forceinline__ int leaf_of(const Leaves& L, int c) {
  int j = 0;
#pragma unroll
  for (int q = 1; q < MAX_LEAVES; ++q) j += c >= L.col0[q] ? 1 : 0;
  return j;
}

// the first position in [lo, hi) whose index is >= r, or hi; a whole warp
// calls it with the same arguments (a 33-ary search, then one probe)
__device__ long long warp_lower_bound(const long long* __restrict__ idx,
                                      long long lo, long long hi,
                                      long long r) {
  const int lane = threadIdx.x & 31;
  while (hi - lo > 32) {
    const long long pos = lo + (hi - lo) * (lane + 1) / 33;
    const int m = __popc(__ballot_sync(FULL, idx[pos] < r));
    const long long new_lo = m == 0 ? lo : __shfl_sync(FULL, pos, m - 1) + 1;
    const long long new_hi = m == 32 ? hi : __shfl_sync(FULL, pos, m);
    lo = new_lo;
    hi = new_hi;
  }
  const long long pos = lo + lane;
  return lo + __popc(__ballot_sync(FULL, pos < hi && idx[pos] < r));
}

// the first position in [lo, hi) of s whose value is >= r, or hi
__device__ __forceinline__ int lower_bound(const long long* s, int lo, int hi,
                                           long long r) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] < r) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// a piece's two fragments, as positions: [head0, head1) of the run that
// comes from the piece before (slot 0), [tail0, tail1) of the run that
// goes on into the next one (slot 1, where a crossing run starts); empty
// where there is none
struct Fragments {
  long long head0, head1, tail0, tail1;
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned at = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(at),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait for all but the last group committed
__device__ __forceinline__ void cp_async_wait_all_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// start staging g_j's rows [a, a + n) of every leaf in shared memory, leaf
// after leaf (leaf j's at n col0[j]): the leaves' rows as one run of
// 16-byte asynchronous copies where n keeps them aligned (a is a multiple
// of PIECE), else as 4-byte loads (the last entries of idx only)
__device__ __forceinline__ void stage_rows(const Leaves& L, long long a,
                                           int n, float* s_g) {
  if (n % 4 == 0) {
    const int n_q = n * L.col0[MAX_LEAVES] / 4;  // n K / 4
    for (int q = threadIdx.x; q < n_q; q += THREADS) {
      const int j = leaf_of(L, q / (n / 4));  // leaf j's quads: n k_j / 4
      const int at = q - n * L.col0[j] / 4;
      cp_async16(reinterpret_cast<float4*>(s_g) + q,
                 reinterpret_cast<const float4*>(L.g[j] + a * L.k[j]) + at);
    }
  } else {
    for (int j = 0; j < L.n; ++j) {
      const int nf = n * L.k[j];
      const float* src = L.g[j] + a * L.k[j];
      float* dst = s_g + n * L.col0[j];
      for (int f = threadIdx.x; f < nf; f += THREADS) dst[f] = __ldg(src + f);
    }
  }
}

// acc plus column cc of a leaf of width k staged at s (its rows from
// entry a0), over entries [a, b), in entry order
__device__ __forceinline__ float staged_sum(float acc, const float* s, int k,
                                            int cc, long long a0, long long a,
                                            long long b) {
  const float* p = s + (a - a0) * k + cc;
#pragma unroll 8
  for (long long i = a; i < b; ++i, p += k) acc = acc + *p;
  return acc;
}

// a block: `group` consecutive pieces (at most MAX_GROUP), a thread a
// (piece, column) pair; their rows pass through shared memory in chunks
// of `chunk` entries, two buffers, the next chunk's copies in flight while
// the current one is added
__global__ void __launch_bounds__(THREADS) piece_sums(
    const long long* __restrict__ idx, long long V, int K,
    const __grid_constant__ Leaves L, Work W, int group, int chunk,
    long long n_pieces) {
  __shared__ Fragments s_frag[MAX_GROUP];
  __shared__ int s_need;
  // two buffers of chunk K floats, then s_idx: s_idx[1 + i] = idx[A + i],
  // s_idx[0] = idx[A - 1] (-1 before the first entry) and s_idx[n + 1] =
  // idx[E] (-2 after the last)
  extern __shared__ __align__(16) float s_buf[];
  long long* s_idx = reinterpret_cast<long long*>(s_buf + 2 * chunk * K);
  const long long p0 = (long long)blockIdx.x * group;
  const int np = (int)min((long long)group, n_pieces - p0);
  const long long A = p0 * PIECE, E = min(V, (p0 + np) * PIECE);
  const int n = (int)(E - A);
  if (threadIdx.x == 0) s_need = 0;
  for (int i = threadIdx.x; i < n + 2; i += THREADS) {
    const long long at = A + i - 1;
    s_idx[i] = at < 0 ? -1 : (at >= V ? -2 : idx[at]);
  }
  __syncthreads();
  if (threadIdx.x < np) {
    const int a = threadIdx.x * PIECE, e = min(n, a + PIECE);
    const long long first = s_idx[1 + a], last = s_idx[e];
    const bool from_prev = s_idx[a] == first;
    const bool to_next = s_idx[e + 1] == last;
    Fragments f{A + a, A + a, A + e, A + e};
    if (from_prev)
      f.head1 = A + (first == last ? e
                                   : lower_bound(s_idx, 1 + a, 1 + e,
                                                 first + 1) - 1);
    if (to_next && !(from_prev && first == last))
      f.tail0 = A + lower_bound(s_idx, 1 + a, 1 + e, last) - 1;
    s_frag[threadIdx.x] = f;
    if (f.head1 > f.head0 || f.tail1 > f.tail0) s_need = 1;
  }
  __syncthreads();
  const bool need = s_need != 0;
  const int n_chunks = (n + chunk - 1) / chunk;
  auto stage = [&](int ch) {
    const long long a = A + (long long)ch * chunk;
    stage_rows(L, a, (int)(min(E, a + chunk) - a),
               s_buf + (ch & 1) * chunk * K);
  };
  if (need) stage(0);
  cp_async_commit();
  // the end of the crossing run that starts in each piece: a warp a piece
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int pl = warp; pl < np; pl += THREADS / 32) {
    const Fragments f = s_frag[pl];
    long long end = -1;
    if (f.tail1 > f.tail0)
      end = warp_lower_bound(idx, f.tail1, V, s_idx[f.tail1 - A] + 1);
    if (lane == 0) W.run_end[p0 + pl] = end;
  }
  if (!need) return;
  // this thread's pair (np K <= THREADS: group K <= 48 where group > 1)
  const int pl = threadIdx.x / K, c = threadIdx.x % K;
  const bool mine = pl < np;
  Fragments f{};
  int j = 0, k = 1, cc = 0;
  if (mine) {
    f = s_frag[pl];
    j = leaf_of(L, c);
    k = L.k[j];
    cc = c - L.col0[j];
  }
  float head = 0.0f, tail = 0.0f;
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks) stage(ch + 1);
    cp_async_commit();
    cp_async_wait_all_but_last();
    __syncthreads();
    if (mine) {
      const long long a0 = A + (long long)ch * chunk, a1 = min(E, a0 + chunk);
      const float* s = s_buf + (ch & 1) * chunk * K +
                       (a1 - a0) * L.col0[j];
      head = staged_sum(head, s, k, cc, a0, max(f.head0, a0),
                        min(f.head1, a1));
      tail = staged_sum(tail, s, k, cc, a0, max(f.tail0, a0),
                        min(f.tail1, a1));
    }
    __syncthreads();
  }
  if (mine) {
    float* slot = W.part + (p0 + pl) * 2 * K + c;
    if (f.head1 > f.head0) slot[0] = head;
    if (f.tail1 > f.tail0) slot[K] = tail;
  }
}

__device__ __forceinline__ bool crossing(long long a, long long b) {
  return b > a && a / PIECE != (b - 1) / PIECE;
}

// a block: ROWS output rows
__global__ void __launch_bounds__(THREADS) row_sums(
    const long long* __restrict__ idx, long long V, long long C,
    const __grid_constant__ Leaves L) {
  __shared__ long long s_start[ROWS + 1];
  __shared__ long long s_win[WINDOW];
  __shared__ int s_named[ROWS];   // the rows with a run inside one piece
  __shared__ bool s_cross[ROWS];  // the rows of a crossing run
  __shared__ int s_n_named, s_crossing;
  __shared__ long long s_bounds[2];
  const long long r0 = (long long)blockIdx.x * ROWS;
  const int nr = (int)min((long long)ROWS, C - r0);
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {  // the rows' first entry and the next rows'
    const long long b = warp_lower_bound(idx, 0, V, r0 + (warp ? nr : 0));
    if ((threadIdx.x & 31) == 0) s_bounds[warp] = b;
  }
  if (threadIdx.x == 0) s_n_named = s_crossing = 0;
  __syncthreads();
  const long long lo = s_bounds[0], hi = s_bounds[1];
  const int n_win = (int)min((long long)WINDOW, hi - lo);
#pragma unroll 2
  for (int i = threadIdx.x; i < n_win; i += THREADS) s_win[i] = idx[lo + i];
  __syncthreads();
  for (int i = threadIdx.x; i <= nr; i += THREADS) {
    const long long r = r0 + i;
    long long at;
    if (i == 0) {
      at = lo;
    } else if (i == nr) {
      at = hi;
    } else if (n_win == hi - lo || s_win[n_win - 1] >= r) {
      at = lo + lower_bound(s_win, 0, n_win, r);
    } else {  // past the window: a long run before this row
      long long a = lo + n_win, b = hi;
      while (a < b) {
        const long long mid = a + (b - a) / 2;
        if (idx[mid] < r) a = mid + 1; else b = mid;
      }
      at = a;
    }
    s_start[i] = at;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < nr; i += THREADS) {
    const long long a = s_start[i], b = s_start[i + 1];
    s_cross[i] = crossing(a, b);
    if (s_cross[i])
      s_crossing = 1;
    else if (b > a)
      s_named[atomicAdd(&s_n_named, 1)] = i;
  }
  __syncthreads();
  // every float of the rows no crossing run names: init (the named rows'
  // are written again below), in 16-byte stores; a crossing run's row is
  // run_sums' to write
  const bool any_crossing = s_crossing != 0;
  for (int j = 0; j < L.n; ++j) {
    const int k = L.k[j];
    const float* __restrict__ base = L.base[j] ? L.base[j] + r0 * k : nullptr;
    float* __restrict__ out = L.out[j] + r0 * k;
    const int n_f = nr * k;
    // r0 k is a multiple of 4 (ROWS is), so the quads are 16-byte aligned
    for (int q = threadIdx.x; q * 4 < n_f; q += THREADS) {
      const int f0 = 4 * q, f1 = min(n_f, f0 + 4);
      // the quad's rows, f0 / k to (f1 - 1) / k
      bool clear = f1 - f0 == 4;
      if (any_crossing)
        for (int row = f0 / k; row <= (f1 - 1) / k; ++row)
          clear = clear && !s_cross[row];
      if (clear) {
        reinterpret_cast<float4*>(out)[q] =
            base ? __ldg(reinterpret_cast<const float4*>(base) + q)
                 : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      } else {
        for (int f = f0; f < f1; ++f)
          if (!s_cross[f / k]) out[f] = base ? base[f] : 0.0f;
      }
    }
  }
  __syncthreads();
  // the named rows: init plus the run, in entry order
  const int n_named = s_n_named;
  for (int j = 0; j < L.n; ++j) {
    const int k = L.k[j];
    const float* __restrict__ g = L.g[j];
    for (int q = threadIdx.x; q < n_named * k; q += THREADS) {
      const int i = s_named[q / k], col = q % k;
      const long long at = (r0 + i) * k + col;
      float acc = L.base[j] ? L.base[j][at] : 0.0f;
      for (long long e = s_start[i]; e < s_start[i + 1]; ++e)
        acc = acc + __ldg(g + e * k + col);
      L.out[j][at] = acc;
    }
  }
}

// 32 pieces, RUN_COLS columns: each crossing run that starts in them, its
// fragments t = 0 (its first piece's slot 1), then t > 0 (piece p + t's
// slot 0), in SHARES contiguous shares
// a block: 32 pieces (blockIdx.x), RUN_COLS columns (blockIdx.y)
__global__ void __launch_bounds__(THREADS) run_sums(
    const long long* __restrict__ idx, int K,
    const __grid_constant__ Leaves L, Work W, long long n_pieces) {
  const long long pb = (long long)blockIdx.x * 32;
  const int c0 = blockIdx.y * RUN_COLS;
  __shared__ long long s_end[32];
  __shared__ float s_sum[SHARES][RUN_COLS];
  if (threadIdx.x < 32)
    s_end[threadIdx.x] =
        pb + threadIdx.x < n_pieces ? W.run_end[pb + threadIdx.x] : -1;
  __syncthreads();
  const int share = threadIdx.x / RUN_COLS, tc = threadIdx.x % RUN_COLS;
  const int c = c0 + tc;
  for (int s = 0; s < 32; ++s) {
    const long long end = s_end[s];
    if (end < 0) continue;
    const long long p = pb + s;
    const int n_frag = (int)((end - 1) / PIECE - p + 1);
    const int per = (n_frag + SHARES - 1) / SHARES;
    const int t0 = share * per, t1 = min(n_frag, t0 + per);
    float acc = 0.0f;
    if (c < K) {
#pragma unroll 32
      for (int t = t0; t < t1; ++t)
        acc = acc + W.part[((p + t) * 2 + (t == 0 ? 1 : 0)) * K + c];
    }
    s_sum[share][tc] = acc;
    __syncthreads();
    if (share == 0 && c < K) {
      float total = 0.0f;
#pragma unroll
      for (int q = 0; q < SHARES; ++q) total = total + s_sum[q][tc];
      const int j = leaf_of(L, c);
      const long long r = idx[p * PIECE + PIECE - 1];
      const long long at = r * L.k[j] + (c - L.col0[j]);
      const float init = L.base[j] ? L.base[j][at] : 0.0f;
      L.out[j][at] = init + total;
    }
    __syncthreads();
  }
}

// a side stream and two events a device, made at first use and kept
struct Side {
  cudaStream_t stream;
  cudaEvent_t fork, join;
};

cudaError_t side_of(int device, Side& out) {
  constexpr int MAX_DEVICES = 64;
  static Side sides[MAX_DEVICES];
  static bool made[MAX_DEVICES];
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  if (!made[device]) {
    Side s{};
    cudaError_t e =
        cudaStreamCreateWithFlags(&s.stream, cudaStreamNonBlocking);
    if (e == cudaSuccess)
      e = cudaEventCreateWithFlags(&s.fork, cudaEventDisableTiming);
    if (e == cudaSuccess)
      e = cudaEventCreateWithFlags(&s.join, cudaEventDisableTiming);
    if (e != cudaSuccess) return e;
    sides[device] = s;
    made[device] = true;
  }
  out = sides[device];
  return cudaSuccess;
}

long long n_pieces_of(long long V) { return (V + PIECE - 1) / PIECE; }
long long n_row_blocks_of(long long C) { return (C + ROWS - 1) / ROWS; }
// the partial rows' floats, rounded up to an even count (int64 follow)
long long part_floats(long long V, int K) {
  return (n_pieces_of(V) * 2 * K + 1) / 2 * 2;
}

}  // namespace

// The float workspace a call needs (see Work).
extern "C" int bs_gather_rows_bwd_workspace(long long V, int K,
                                            long long* n_float) {
  if (V < 1 || V >= (1LL << 31) || K < 1) return (int)cudaErrorInvalidValue;
  *n_float = part_floats(V, K) + 2 * n_pieces_of(V);
  return 0;
}

// idx [V] int64 nondecreasing in [0, C); g[j] [V, k[j]] float32, base[j]
// [C, k[j]] float32 or null and out[j] [C, k[j]] float32 (16-byte aligned,
// out[j] not base[j]) for the n leaves (host arrays of device pointers;
// base itself null for no bases); ws the workspace of
// bs_gather_rows_bwd_workspace (8-byte aligned).
extern "C" int bs_gather_rows_bwd(const long long* idx, long long V,
                                  long long C, int n, const float* const* g,
                                  const float* const* base,
                                  float* const* out, const int* k, float* ws,
                                  void* stream) {
  if (n < 1 || n > MAX_LEAVES || V < 1 || V >= (1LL << 31) || C < 1 ||
      C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Leaves L{};
  L.n = n;
  int K = 0;
  for (int j = 0; j < n; ++j) {
    if (k[j] < 1 || C * k[j] >= (1LL << 31)) return (int)cudaErrorInvalidValue;
    L.g[j] = g[j];
    L.base[j] = base ? base[j] : nullptr;
    L.out[j] = out[j];
    L.k[j] = k[j];
    L.col0[j] = K;
    K += k[j];
  }
  for (int j = n; j <= MAX_LEAVES; ++j) L.col0[j] = K;
  if (K > MAX_K) return (int)cudaErrorInvalidValue;
  const long long pieces = n_pieces_of(V), row_blocks = n_row_blocks_of(C);
  Work W;
  W.part = ws;
  W.run_end = reinterpret_cast<long long*>(ws + part_floats(V, K));
  const auto st = (cudaStream_t)stream;
  // a block's pieces: as many as CHUNK_BYTES of rows hold, at least one;
  // a chunk: as many entries as CHUNK_BYTES hold, a multiple of 4 (16-byte
  // aligned rows), at most the block's
  const int group = max(1, min(MAX_GROUP, CHUNK_BYTES / (PIECE * K * 4)));
  const int chunk =
      min(group * PIECE, max(4, CHUNK_BYTES / (K * 4) / 4 * 4));
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  Side side{};
  if (e == cudaSuccess) e = side_of(device, side);
  if (e != cudaSuccess) return (int)e;
  const long long piece_blocks = (pieces + group - 1) / group;
  const int smem = 2 * chunk * K * 4 +
                   (group * PIECE + 2) * (int)sizeof(long long);
  e = cudaFuncSetAttribute(piece_sums,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  // the rows on the side stream, beside the pieces and then the runs on
  // the caller's: the rows' writes overlap the pieces' reads
  e = cudaEventRecord(side.fork, st);
  if (e == cudaSuccess) e = cudaStreamWaitEvent(side.stream, side.fork, 0);
  if (e != cudaSuccess) return (int)e;
  row_sums<<<(unsigned)row_blocks, THREADS, 0, side.stream>>>(idx, V, C, L);
  piece_sums<<<(unsigned)piece_blocks, THREADS, smem, st>>>(
      idx, V, K, L, W, group, chunk, pieces);
  const dim3 runs((unsigned)((pieces + 31) / 32),
                  (unsigned)((K + RUN_COLS - 1) / RUN_COLS));
  run_sums<<<runs, THREADS, 0, st>>>(idx, K, L, W, pieces);
  e = cudaGetLastError();
  if (e == cudaSuccess) e = cudaEventRecord(side.join, side.stream);
  if (e == cudaSuccess) e = cudaStreamWaitEvent(st, side.join, 0);
  return (int)e;
}
