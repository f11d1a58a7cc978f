// hashgrid_bwd -- the hash grid's backward: a fixed-order sum of the corner
// gathers' cotangent rows into the table.
//
// No TPU kernel is replaced: the JAX package's hash grid is pure jnp
// (bloomscene_tpu/ops/hashgrid.py), and XLA's scatter-add does this work
// there. On the card, the backward of the corner gathers was
// ``index_add_``, whose atomic float adds land in no fixed order, so two
// identical phase-2 steps gave different table gradients.
//
// What it computes: out[idx[i]] += rows[i] over the M entries of one
// encoder (every level and corner of every anchor) into a table out
// [n_cells, F]; a cell no entry names is 0. Every cell is written, so
// ``out`` needs no zeroing.
//
// What bounds it on an H100: bytes -- per entry 8 bytes of cell and 4 F
// bytes of row read once, and the table written once; F adds an entry.
//
// The design. A cell's window is its index >> WB (W = 2^WB cells, 512 at
// F = 4): a window's table of W x F floats (8 KB) fits one warp's share of
// shared memory.
// 1. Sort (a stable LSD radix sort on the window, 8 bits a pass: one pass
//    while the table has at most 256 windows, as the grid's encoders do,
//    ~96K-115K cells). Each pass: radix_hist counts each block's 2,048
//    entries by digit (integer counts: any order gives the same);
//    radix_scan turns the [digit, block] counts into offsets, one block a
//    digit; radix_scatter ranks each entry within its warp by
//    __match_any_sync in lane order, places the block's cells and 16-byte
//    rows in that order in shared memory (45 KB) and writes each digit's
//    run contiguously (16-byte rows written one by one to scattered places
//    leave L2 sectors partly written: half the speed), so the summing pass
//    reads the rows contiguously too. The order within a window stays the
//    entries' order.
// 2. Sum. chunk_layout cuts each window's run into chunks of CHUNK sorted
//    entries; window_sums gives each chunk one warp, which adds its
//    entries into its own zeroed table in shared memory 32 at a time (a
//    step): lanes on consecutive entries, so every load is coalesced.
//    Neighbouring anchors share cells at the coarse levels, and every dead
//    anchor sits at one point (one cell of each level and corner holds
//    ~28K entries in a training step), so a step's cells come in runs on
//    consecutive lanes: a segmented Hillis-Steele scan (5 shuffle steps)
//    sums each run into its last lane, and the runs' sums go into the
//    table in rounds, the r-th run of each cell in round r, so each cell
//    takes its runs in list order. The warp then writes its table to a
//    partial. cell_sums adds each cell's partials in chunk order and
//    writes the cell.
// Every sum has a fixed order, so two launches give the same bits; the
// only atomics are integer counts. tests/test_torch_kernels.py::
// chunked_segment_sum is a numpy twin of this order.
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int RADIX_BITS = 8;
constexpr int RADIX = 1 << RADIX_BITS;
constexpr int P_THREADS = 256;              // radix passes: 8 warps
constexpr int P_WARPS = P_THREADS / 32;
constexpr int P_ITEMS = 8;                  // entries a lane takes a pass
constexpr int WARP_E = 32 * P_ITEMS;        // a warp's contiguous entries
constexpr int TILE_E = P_WARPS * WARP_E;    // a block's: 2,048
constexpr int S_WARPS = 4;                  // window_sums: 4 warps, 32 KB
constexpr int CHUNK = 2048;                 // sorted entries a warp sums
constexpr int TABLE_FLOATS = 2048;          // a warp's table: W * F
constexpr int SCAN_THREADS = 1024;
static_assert(RADIX == P_THREADS, "one digit a thread in radix_scatter");

// W = 2^WB cells a window: the most that fit TABLE_FLOATS at F features
__host__ __device__ constexpr int window_bits(int F) {
  int b = 0;
  while ((2 << b) * F <= TABLE_FLOATS) ++b;
  return b;
}

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

// exclusive scan of one value a thread over a block of 32 * n_warps
// threads; ``sums`` holds n_warps ints; returns the block's total too
__device__ __forceinline__ int block_exclusive_scan(int v, int* sums,
                                                    int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int w = lane < n_warps ? sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL, w, o);
      if (lane >= o) w += y;
    }
    if (lane < n_warps) sums[lane] = w;
  }
  __syncthreads();
  *total = sums[n_warps - 1];
  const int out = (warp ? sums[warp - 1] : 0) + x - v;
  __syncthreads();  // sums may be reused
  return out;
}

template <typename KeyT>
__device__ __forceinline__ int digit_of(KeyT key, int shift) {
  return (int)((key >> shift) & (KeyT)(RADIX - 1));
}

// counts of each block's TILE_E entries by digit -> hist[digit][block]
template <typename KeyT>
__global__ void __launch_bounds__(P_THREADS) radix_hist(
    const KeyT* __restrict__ keys, long long M, int shift, int n_blocks,
    int* __restrict__ hist) {
  __shared__ int h[RADIX];
  const int lane = threadIdx.x & 31;
  for (int d = threadIdx.x; d < RADIX; d += P_THREADS) h[d] = 0;
  __syncthreads();
  const long long base = (long long)blockIdx.x * TILE_E;
  for (int j = threadIdx.x; j < TILE_E; j += P_THREADS) {
    const long long i = base + j;
    const bool ok = i < M;
    const int d = ok ? digit_of(keys[i], shift) : RADIX;
    const unsigned peers = __match_any_sync(FULL, d);
    if (ok && lane == __ffs(peers) - 1) atomicAdd(&h[d], __popc(peers));
  }
  __syncthreads();
  for (int d = threadIdx.x; d < RADIX; d += P_THREADS)
    hist[(long long)d * n_blocks + blockIdx.x] = h[d];
}

// each digit's row of block counts -> exclusive offsets within the digit,
// and the digit's total; one block a digit
__global__ void __launch_bounds__(SCAN_THREADS) radix_scan(
    int* __restrict__ hist, int n_blocks, int* __restrict__ totals) {
  __shared__ int sums[SCAN_THREADS / 32];
  int* row = hist + (long long)blockIdx.x * n_blocks;
  int carry = 0;
  for (int base = 0; base < n_blocks; base += SCAN_THREADS) {
    const int i = base + threadIdx.x;
    const int v = i < n_blocks ? row[i] : 0;
    int total;
    const int ex = block_exclusive_scan(v, sums, &total);
    if (i < n_blocks) row[i] = carry + ex;
    carry += total;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

// each entry of the block to its place: digit start + the block's offset +
// the warps before it + its rank among the warp's earlier entries of that
// digit (lane order within a step); its cell (int32) and row go with it.
// The block first places its entries in that order in shared memory, so
// that it writes each digit's entries as one contiguous, coalesced run.
template <int F>
constexpr int scatter_smem() {
  return (int)sizeof(float) * TILE_E * F + (int)sizeof(int) * TILE_E +
         (int)sizeof(int) * (P_WARPS * (RADIX + 1) + RADIX);
}

template <typename KeyT, int F>
__global__ void __launch_bounds__(P_THREADS) radix_scatter(
    const KeyT* __restrict__ keys, const float* __restrict__ rows,
    long long M, int shift, int n_blocks, const int* __restrict__ hist,
    const int* __restrict__ totals, int* __restrict__ keys_out,
    float* __restrict__ rows_out) {
  extern __shared__ __align__(16) float smem[];
  float* srows = smem;                                   // [TILE_E][F]
  int* skeys = reinterpret_cast<int*>(srows + TILE_E * F);  // [TILE_E]
  // [P_WARPS][RADIX + 1]: +1 for the invalid lanes' digit
  int* offs = skeys + TILE_E;
  int* delta = offs + P_WARPS * (RADIX + 1);             // [RADIX]
  __shared__ int sums[P_WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int* woffs = offs + warp * (RADIX + 1);
  for (int i = threadIdx.x; i < P_WARPS * (RADIX + 1); i += P_THREADS)
    offs[i] = 0;
  __syncthreads();
  const long long tile0 = (long long)blockIdx.x * TILE_E;
  const long long wbase = tile0 + warp * WARP_E;
  // the warp's counts by digit (the keys are read again below, from cache)
#pragma unroll
  for (int k = 0; k < P_ITEMS; ++k) {
    const long long i = wbase + k * 32 + lane;
    const bool ok = i < M;
    const int d = ok ? digit_of(keys[i], shift) : RADIX;
    const unsigned peers = __match_any_sync(FULL, d);
    if (lane == __ffs(peers) - 1) woffs[d] += __popc(peers);
    __syncwarp();
  }
  __syncthreads();
  // thread t owns digit t: its start in the block's tile (local) and over
  // all blocks (global), then each warp's local start in warp order
  {
    const int t = threadIdx.x;
    int count = 0;
    for (int w = 0; w < P_WARPS; ++w) count += offs[w * (RADIX + 1) + t];
    int all;
    const int local = block_exclusive_scan(count, sums, &all);
    const int global = block_exclusive_scan(totals[t], sums, &all) +
                       hist[(long long)t * n_blocks + blockIdx.x];
    delta[t] = global - local;
    int base = local;
    for (int w = 0; w < P_WARPS; ++w) {
      const int c = offs[w * (RADIX + 1) + t];
      offs[w * (RADIX + 1) + t] = base;
      base += c;
    }
  }
  __syncthreads();
  // each entry to its local place
#pragma unroll
  for (int k = 0; k < P_ITEMS; ++k) {
    const long long i = wbase + k * 32 + lane;
    const bool ok = i < M;
    const KeyT key = ok ? keys[i] : (KeyT)0;
    const int d = ok ? digit_of(key, shift) : RADIX;
    const unsigned peers = __match_any_sync(FULL, d);
    const int pos = woffs[d] + __popc(peers & lanes_below(lane));
    __syncwarp();
    if (lane == __ffs(peers) - 1) woffs[d] += __popc(peers);
    __syncwarp();
    if (!ok) continue;
    skeys[pos] = (int)key;
    if constexpr (F == 4) {
      reinterpret_cast<float4*>(srows)[pos] =
          reinterpret_cast<const float4*>(rows)[i];
    } else {
#pragma unroll
      for (int f = 0; f < F; ++f) srows[pos * F + f] = rows[i * F + f];
    }
  }
  __syncthreads();
  // the tile in local order: each digit's run to its global place
  const int n = (int)min((long long)TILE_E, M - tile0);
  for (int j = threadIdx.x; j < n; j += P_THREADS) {
    const int key = skeys[j];
    const long long g = (long long)delta[(key >> shift) & (RADIX - 1)] + j;
    keys_out[g] = key;
    if constexpr (F == 4) {
      reinterpret_cast<float4*>(rows_out)[g] =
          reinterpret_cast<const float4*>(srows)[j];
    } else {
#pragma unroll
      for (int f = 0; f < F; ++f) rows_out[g * F + f] = srows[j * F + f];
    }
  }
}

// entries a window holds (sorted keys), for a sort of more than one pass
__global__ void __launch_bounds__(P_THREADS) window_count(
    const int* __restrict__ keys, long long M, int wb,
    int* __restrict__ counts) {
  const int lane = threadIdx.x & 31;
  const long long stride = (long long)gridDim.x * P_THREADS;
  for (long long base = (long long)blockIdx.x * P_THREADS + threadIdx.x -
                        lane;
       base < M; base += stride) {
    const long long i = base + lane;
    const int b = i < M ? keys[i] >> wb : -1;
    const unsigned peers = __match_any_sync(FULL, b);
    if (b >= 0 && lane == __ffs(peers) - 1) atomicAdd(&counts[b],
                                                      __popc(peers));
  }
}

// window starts and chunk starts (exclusive scans, n_win + 1 each) from the
// windows' entry counts; one block
__global__ void __launch_bounds__(SCAN_THREADS) chunk_layout(
    const int* __restrict__ counts, int n_win, int* __restrict__ win_start,
    int* __restrict__ chunk_start) {
  __shared__ int sums[SCAN_THREADS / 32];
  int carry_e = 0, carry_c = 0;
  for (int base = 0; base < n_win; base += SCAN_THREADS) {
    const int b = base + threadIdx.x;
    const int c = b < n_win ? counts[b] : 0;
    int te, tc;
    const int ee = block_exclusive_scan(c, sums, &te);
    const int ec = block_exclusive_scan((c + CHUNK - 1) / CHUNK, sums, &tc);
    if (b < n_win) {
      win_start[b] = carry_e + ee;
      chunk_start[b] = carry_c + ec;
    }
    carry_e += te;
    carry_c += tc;
  }
  if (threadIdx.x == 0) {
    win_start[n_win] = carry_e;
    chunk_start[n_win] = carry_c;
  }
}

// dst[f] = dst[f] + v[f] in shared memory (one 16-byte access each way
// at F = 4)
template <int F>
__device__ __forceinline__ void add_row(float* dst, const float* v) {
  if constexpr (F == 4) {
    float4 t = *reinterpret_cast<float4*>(dst);
    t.x = t.x + v[0];
    t.y = t.y + v[1];
    t.z = t.z + v[2];
    t.w = t.w + v[3];
    *reinterpret_cast<float4*>(dst) = t;
  } else {
#pragma unroll
    for (int f = 0; f < F; ++f) dst[f] = dst[f] + v[f];
  }
}

// one warp a chunk: its window's table of the chunk's entries -> part
template <int F>
__global__ void __launch_bounds__(S_WARPS * 32) window_sums(
    const int* __restrict__ keys, const float* __restrict__ rows, int n_win,
    const int* __restrict__ win_start, const int* __restrict__ chunk_start,
    float* __restrict__ part) {
  constexpr int WB = window_bits(F);
  constexpr int W = 1 << WB;
  constexpr int TF = W * F;
  constexpr int UNROLL = F <= 4 ? 8 : 4;  // steps whose loads go together
  __shared__ __align__(16) float table[S_WARPS][TF];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = blockIdx.x * S_WARPS + warp;
  if (g >= chunk_start[n_win]) return;
  // the window whose chunks hold g: the last b with chunk_start[b] <= g
  int lo = 0, hi = n_win;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (chunk_start[mid] <= g) lo = mid; else hi = mid;
  }
  const long long e0 =
      win_start[lo] + (long long)(g - chunk_start[lo]) * CHUNK;
  const long long e1 = min(e0 + CHUNK, (long long)win_start[lo + 1]);
  float* tab = table[warp];
  for (int i = lane * 4; i < TF; i += 128)
    *reinterpret_cast<float4*>(tab + i) = make_float4(0.f, 0.f, 0.f, 0.f);
  __syncwarp();
  for (long long s0 = e0; s0 < e1; s0 += 32 * UNROLL) {
    int k[UNROLL];
    float v[UNROLL][F];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const long long i = s0 + u * 32 + lane;
      const bool ok = i < e1;
      k[u] = ok ? keys[i] & (W - 1) : -1;
      if constexpr (F == 4) {
        const float4 r = ok ? reinterpret_cast<const float4*>(rows)[i]
                            : make_float4(0.f, 0.f, 0.f, 0.f);
        v[u][0] = r.x; v[u][1] = r.y; v[u][2] = r.z; v[u][3] = r.w;
      } else {
#pragma unroll
        for (int f = 0; f < F; ++f) v[u][f] = ok ? rows[i * F + f] : 0.0f;
      }
    }
    // the steps' runs and ranks first (independent steps, so their
    // shuffles overlap), then their table adds in step order
    bool tail[UNROLL];
    int rank[UNROLL], rounds[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int kk = k[u];
      // runs of one cell on consecutive lanes (neighbouring anchors share
      // cells): each run's rows summed by a segmented Hillis-Steele scan,
      // the run's last lane holding its sum
      const int prev = __shfl_up_sync(FULL, kk, 1);
      const bool head = lane == 0 || prev != kk;
      const unsigned heads = __ballot_sync(FULL, head);
      if (heads != FULL) {
        const int start = 31 - __clz(heads & (FULL >> (31 - lane)));
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
          for (int f = 0; f < F; ++f) {
            const float y = __shfl_up_sync(FULL, v[u][f], off);
            if (lane - off >= start) v[u][f] = v[u][f] + y;
          }
        }
      }
      const int next = __shfl_down_sync(FULL, kk, 1);
      tail[u] = (lane == 31 || next != kk) && kk >= 0;
      // round r adds the r-th run of each cell in the step
      const unsigned peers = __match_any_sync(FULL, tail[u] ? kk : -2 - lane);
      rank[u] = __popc(peers & lanes_below(lane));
      rounds[u] =
          (int)__reduce_max_sync(FULL, tail[u] ? (unsigned)rank[u] : 0u) + 1;
    }
    // the runs' sums into the table in lane order
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      for (int r = 0; r < rounds[u]; ++r) {
        if (tail[u] && rank[u] == r) add_row<F>(tab + k[u] * F, v[u]);
        __syncwarp();
      }
    }
  }
  float* dst = part + (long long)g * TF;
  for (int i = lane * 4; i < TF; i += 128)
    *reinterpret_cast<float4*>(dst + i) =
        *reinterpret_cast<const float4*>(tab + i);
}

// each cell: its window's partials added in chunk order
template <int F>
__global__ void __launch_bounds__(256) cell_sums(
    const float* __restrict__ part, const int* __restrict__ chunk_start,
    int n_cells, float* __restrict__ out) {
  constexpr int WB = window_bits(F);
  constexpr int W = 1 << WB;
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= n_cells) return;
  const int b = (int)(c >> WB), w = (int)(c & (W - 1));
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
  for (int ch = chunk_start[b]; ch < chunk_start[b + 1]; ++ch) {
    const float* p = part + ((long long)ch * W + w) * F;
#pragma unroll
    for (int f = 0; f < F; ++f) acc[f] = acc[f] + p[f];
  }
#pragma unroll
  for (int f = 0; f < F; ++f) out[c * F + f] = acc[f];
}

// the buffers of one call, carved from the two workspaces in this order
struct Layout {
  int wb, n_win, passes, n_blocks;
  long long chunks_max;
  // int workspace
  long long keys_a, keys_b, hist, totals, counts, win_start, chunk_start,
      n_int;
  // float workspace
  long long rows_a, rows_b, part, n_float;
};

Layout layout(long long M, int F, int n_cells) {
  Layout L{};
  L.wb = window_bits(F);
  L.n_win = (int)((n_cells + (1LL << L.wb) - 1) >> L.wb);
  int bits = 0;
  while ((1LL << bits) < L.n_win) ++bits;
  L.passes = bits > RADIX_BITS ? (bits + RADIX_BITS - 1) / RADIX_BITS : 1;
  L.n_blocks = (int)((M + TILE_E - 1) / TILE_E);
  L.chunks_max = (M + CHUNK - 1) / CHUNK + L.n_win;
  long long o = 0;
  L.keys_a = o; o += M;
  L.keys_b = o; o += L.passes > 1 ? M : 0;
  L.hist = o; o += (long long)RADIX * L.n_blocks;
  L.totals = o; o += RADIX;
  L.counts = o; o += L.passes > 1 ? L.n_win : 0;
  L.win_start = o; o += L.n_win + 1;
  L.chunk_start = o; o += L.n_win + 1;
  L.n_int = o;
  o = 0;
  L.rows_a = o; o += M * F;
  L.rows_b = o; o += L.passes > 1 ? M * F : 0;
  o = (o + 3) / 4 * 4;  // part is written as float4
  L.part = o; o += L.chunks_max * (1LL << L.wb) * F;
  L.n_float = o;
  return L;
}

template <int F>
int run(const long long* idx, const float* rows, long long M, int n_cells,
        int* iws, float* fws, float* out, bool sort_only, cudaStream_t st) {
  const Layout L = layout(M, F, n_cells);
  if (n_cells == 0) return (int)cudaGetLastError();
  if (M == 0) {
    if (!sort_only)
      cudaMemsetAsync(out, 0, sizeof(float) * n_cells * F, st);
    return (int)cudaGetLastError();
  }
  int* hist = iws + L.hist;
  int* totals = iws + L.totals;
  int* keys_io[2] = {iws + L.keys_a, iws + L.keys_b};
  float* rows_io[2] = {fws + L.rows_a, fws + L.rows_b};
  constexpr int smem = scatter_smem<F>();
  // the scatter stages its tile in more than 48 KB of shared memory
  cudaError_t set = cudaFuncSetAttribute(
      radix_scatter<long long, F>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (set == cudaSuccess)
    set = cudaFuncSetAttribute(radix_scatter<int, F>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
  if (set != cudaSuccess) return (int)set;
  for (int pass = 0; pass < L.passes; ++pass) {
    const int shift = L.wb + RADIX_BITS * pass;
    int* k_out = keys_io[pass & 1];
    float* r_out = rows_io[pass & 1];
    if (pass == 0) {
      radix_hist<long long><<<L.n_blocks, P_THREADS, 0, st>>>(
          idx, M, shift, L.n_blocks, hist);
      radix_scan<<<RADIX, SCAN_THREADS, 0, st>>>(hist, L.n_blocks, totals);
      radix_scatter<long long, F><<<L.n_blocks, P_THREADS, smem, st>>>(
          idx, rows, M, shift, L.n_blocks, hist, totals, k_out, r_out);
    } else {
      const int* k_in = keys_io[(pass - 1) & 1];
      const float* r_in = rows_io[(pass - 1) & 1];
      radix_hist<int><<<L.n_blocks, P_THREADS, 0, st>>>(
          k_in, M, shift, L.n_blocks, hist);
      radix_scan<<<RADIX, SCAN_THREADS, 0, st>>>(hist, L.n_blocks, totals);
      radix_scatter<int, F><<<L.n_blocks, P_THREADS, smem, st>>>(
          k_in, r_in, M, shift, L.n_blocks, hist, totals, k_out, r_out);
    }
  }
  if (sort_only) return (int)cudaGetLastError();
  const int* keys = keys_io[(L.passes - 1) & 1];
  const float* srows = rows_io[(L.passes - 1) & 1];
  int* counts = totals;  // one pass: the windows are the digits
  if (L.passes > 1) {
    counts = iws + L.counts;
    cudaMemsetAsync(counts, 0, sizeof(int) * L.n_win, st);
    window_count<<<264, P_THREADS, 0, st>>>(keys, M, L.wb, counts);
  }
  int* win_start = iws + L.win_start;
  int* chunk_start = iws + L.chunk_start;
  chunk_layout<<<1, SCAN_THREADS, 0, st>>>(counts, L.n_win, win_start,
                                           chunk_start);
  const unsigned sum_blocks =
      (unsigned)((L.chunks_max + S_WARPS - 1) / S_WARPS);
  window_sums<F><<<sum_blocks, S_WARPS * 32, 0, st>>>(
      keys, srows, L.n_win, win_start, chunk_start, fws + L.part);
  cell_sums<F><<<(unsigned)((n_cells + 255) / 256), 256, 0, st>>>(
      fws + L.part, chunk_start, n_cells, out);
  return (int)cudaGetLastError();
}

}  // namespace

// The two workspaces a call needs, in ints and floats, and the window
// bits (log2 cells a window) at F features.
extern "C" int bs_hashgrid_bwd_workspace(long long M, int F, int n_cells,
                                         long long* n_int,
                                         long long* n_float, int* wb) {
  if (F < 1 || F > 8 || M < 0 || M >= (1LL << 31) || n_cells < 0)
    return (int)cudaErrorInvalidValue;
  const Layout L = layout(M, F, n_cells);
  *n_int = L.n_int;
  *n_float = L.n_float;
  *wb = L.wb;
  return 0;
}

// idx [M] int64 cells in [0, n_cells), rows [M, F] float32, iws and fws the
// workspaces of bs_hashgrid_bwd_workspace, out [n_cells, F] float32 (every
// cell written). sort_only runs the sort alone (to time it).
extern "C" int bs_hashgrid_bwd(const long long* idx, const float* rows,
                               long long M, int F, int n_cells, int* iws,
                               float* fws, float* out, int sort_only,
                               void* stream) {
  if (F < 1 || F > 8 || M < 0 || M >= (1LL << 31) || n_cells < 0)
    return (int)cudaErrorInvalidValue;
  const auto st = (cudaStream_t)stream;
  switch (F) {
    case 1: return run<1>(idx, rows, M, n_cells, iws, fws, out, sort_only, st);
    case 2: return run<2>(idx, rows, M, n_cells, iws, fws, out, sort_only, st);
    case 3: return run<3>(idx, rows, M, n_cells, iws, fws, out, sort_only, st);
    case 4: return run<4>(idx, rows, M, n_cells, iws, fws, out, sort_only, st);
    case 5: return run<5>(idx, rows, M, n_cells, iws, fws, out, sort_only, st);
    case 6: return run<6>(idx, rows, M, n_cells, iws, fws, out, sort_only, st);
    case 7: return run<7>(idx, rows, M, n_cells, iws, fws, out, sort_only, st);
    default:
      return run<8>(idx, rows, M, n_cells, iws, fws, out, sort_only, st);
  }
}
