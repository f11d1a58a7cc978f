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
// What bounds it on an H100: bytes and latency. Each slot writes 8 bytes
// and the ranks that own a live slot are read once (11 words each); at the
// port's shapes that is 8-20 MB, a few microseconds, so the chain of
// dependent loads before the first store decides the time. The design
// keeps that chain short (the load-balanced search the TPU kernel's
// one-hot window relies on, pairs.py:11-17):
//   - a chunk is CHUNK_SLOTS consecutive slots (THREADS threads of
//     PER_THREAD consecutive slots, stored as one int4 each); since the
//     live ranks are a gap-free prefix, they are owned by at most
//     CHUNK_SLOTS consecutive ranks;
//   - a block's first chunk starts at once: warps 0 and 1 find the ranks
//     owning its first and last slot while warp 2 reads the total and
//     finds the last live rank (the owner of every slot past the total),
//     each by a 32-way search (every lane probes one start, the ballot
//     counts those <= the slot): ceil(log32(n)) = 4-5 rounds of dependent
//     loads at the port's shapes, where one thread's binary search takes
//     log2(n) = 18-21 (a 128-way search, four probes a lane, was slower);
//   - a chunk at or past the total (the tail of an oversized capacity)
//     writes the dead key and the last live rank's id;
//   - a live chunk stages the ranks between into shared memory with
//     coalesced loads (up to WINDOW of them, with the start of the next as
//     lookahead); each thread searches the window for its first slot's rank
//     and walks forward for the rest; a slot past the window (only when
//     ranks that touch no tile sit between live ones) searches the starts
//     beyond it in device memory, so every input gives the plain version's
//     answer;
//   - the grid holds as many blocks as fit on the card at once, each
//     striding over the chunks, so the dead tail costs stores, not a new
//     block's searches (walking a block's chunks last to first, to drain
//     the dead stores behind the live chunk, was slower).
//
// Built with --fmad=false: contracting a multiply and an add into one FMA
// would change the cull's rounding and let keys differ from the plain
// version at the margin.
#include <climits>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int PER_THREAD = 4;
constexpr int CHUNK_SLOTS = THREADS * PER_THREAD;
constexpr int WINDOW = CHUNK_SLOTS;   // ranks staged a chunk

struct Args {
  const int* starts;   // [n + 1], the total last
  const int* x0;
  const int* y0;
  const int* w;
  const int* order;
  const float* atab;   // [6, n] or null for no cull
  int n, pair_capacity, gx, tile, kbits, num_tiles, packed_key;
  int* key_out;
  int* gauss_out;
};

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

// One rank's row: where its slots start, its rectangle, its id and (with
// the cull) mx, my, conic a, b, c and ln(255 opacity).
struct Row {
  int start, x0, y0, w, order;
  float a[6];
};

// How many of s[0, n) are <= v (s nondecreasing), found by one warp: each
// round every lane probes one of 32 evenly spaced starts and the ballot's
// count narrows the interval 32-fold. Warp-uniform result.
__device__ int warp_count_le(const int* __restrict__ s, int n, int v) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int p = lo + (lane + 1) * step - 1;
    const bool le = p < hi && s[p] <= v;
    const int cnt = __popc(__ballot_sync(0xffffffffu, le));
    const int nlo = lo + cnt * step;
    hi = min(hi, nlo + step - 1);
    lo = nlo;
  }
  return lo;
}

// The first index in [lo, hi) with s[i] > v, or hi.
__device__ __forceinline__ int first_above(const int* s, int lo, int hi,
                                           int v) {
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (s[mid] <= v) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int dead_key(const Args& g, int k) {
  return g.packed_key ? ((g.num_tiles << g.kbits) | k) : g.num_tiles;
}

// The key of slot k owned by the rank of ``row``.
__device__ __forceinline__ int slot_key(const Args& g, int k, int total,
                                        const Row& row) {
  const int local = k - row.start;
  const int q = local / row.w;
  const int tx = row.x0 + (local - q * row.w);
  const int ty = row.y0 + q;
  bool live = k < total;
  if (live && g.atab != nullptr) {
    const float mx = row.a[0], my = row.a[1], ca = row.a[2], cb = row.a[3];
    const float cc = row.a[4], ln_t = row.a[5];
    const float ftile = (float)g.tile;
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
  if (!live) return dead_key(g, k);
  const int tid = ty * g.gx + tx;
  return g.packed_key ? ((tid << g.kbits) | k) : tid;
}

// Write one thread's PER_THREAD consecutive slots from kt (one int4 each
// when all lie below the capacity; kt is a multiple of 4).
__device__ __forceinline__ void store4(const Args& g, int kt,
                                       const int (&key)[PER_THREAD],
                                       const int (&gid)[PER_THREAD]) {
  if (kt + PER_THREAD <= g.pair_capacity) {
    *reinterpret_cast<int4*>(g.key_out + kt) =
        make_int4(key[0], key[1], key[2], key[3]);
    *reinterpret_cast<int4*>(g.gauss_out + kt) =
        make_int4(gid[0], gid[1], gid[2], gid[3]);
  } else {
    for (int j = 0; j < PER_THREAD && kt + j < g.pair_capacity; ++j) {
      g.key_out[kt + j] = key[j];
      g.gauss_out[kt + j] = gid[j];
    }
  }
}

// The live chunk from k0: stage its ranks r_first..r_last, then each
// thread's slots.
__device__ void live_chunk(const Args& g, int k0, int total, int r_first,
                           int r_last, int* s_start, int* s_x0, int* s_y0,
                           int* s_w, int* s_order, float (*s_a)[WINDOW]) {
  const int kt = k0 + threadIdx.x * PER_THREAD;
  const int k_end = min(k0 + CHUNK_SLOTS, g.pair_capacity);
  const int m = r_last - r_first + 1;
  const int mw = min(m, WINDOW);
  const bool cull = g.atab != nullptr;
  for (int i = threadIdx.x; i < mw; i += THREADS) {
    const int r = r_first + i;
    s_start[i] = g.starts[r];
    s_x0[i] = g.x0[r];
    s_y0[i] = g.y0[r];
    s_w[i] = g.w[r];
    s_order[i] = g.order[r];
    if (cull) {
      for (int c = 0; c < 6; ++c)
        s_a[c][i] = g.atab[(long long)c * g.n + r];
    }
  }
  if (threadIdx.x == 0)
    s_start[mw] = m > WINDOW ? g.starts[r_first + WINDOW] : INT_MAX;
  __syncthreads();
  if (kt >= k_end) return;

  const int ahead = s_start[mw];
  int i = -1;   // window index of the current rank
  Row row;
  int key[PER_THREAD], gid[PER_THREAD];
  for (int j = 0; j < PER_THREAD; ++j) {
    const int k = kt + j;
    if (k >= k_end) break;
    const int v = min(k, total - 1);
    if (v < ahead) {
      int ni = i < 0 ? first_above(s_start, 0, mw, v) - 1 : i;
      while (ni + 1 < mw && s_start[ni + 1] <= v) ++ni;
      if (ni != i) {
        i = ni;
        row.start = s_start[i];
        row.x0 = s_x0[i];
        row.y0 = s_y0[i];
        row.w = s_w[i];
        row.order = s_order[i];
        if (cull) {
          for (int c = 0; c < 6; ++c) row.a[c] = s_a[c][i];
        }
      }
    } else {
      // past the window: the ranks beyond it, in device memory
      const int r = first_above(g.starts, r_first + WINDOW, r_last + 1, v)
                    - 1;
      i = mw;
      row.start = g.starts[r];
      row.x0 = g.x0[r];
      row.y0 = g.y0[r];
      row.w = g.w[r];
      row.order = g.order[r];
      if (cull) {
        for (int c = 0; c < 6; ++c)
          row.a[c] = g.atab[(long long)c * g.n + r];
      }
    }
    key[j] = slot_key(g, k, total, row);
    gid[j] = row.order;
  }
  store4(g, kt, key, gid);
}

__global__ void __launch_bounds__(THREADS) expand_pairs_kernel(Args g) {
  __shared__ int s_start[WINDOW + 1];   // the last: the lookahead start
  __shared__ int s_x0[WINDOW], s_y0[WINDOW], s_w[WINDOW], s_order[WINDOW];
  __shared__ float s_a[6][WINDOW];
  // the counts of starts <= a chunk's first and last slot; the total, the
  // last live rank and its id
  __shared__ int s_count[2], s_total, s_dead_rank, s_dead_id;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int chunks = (g.pair_capacity + CHUNK_SLOTS - 1) / CHUNK_SLOTS;
  int chunk = blockIdx.x;
  if (warp == 2) {
    const int total = g.starts[g.n];
    const int r = max(warp_count_le(g.starts, g.n, total - 1) - 1, 0);
    if (lane == 0) {
      s_total = total;
      s_dead_rank = r;
      s_dead_id = g.order[r];
    }
  }
  bool search = true;   // the first chunk's searches start before the total
  for (;;) {
    const int k0 = chunk * CHUNK_SLOTS;
    const int k_last = min(k0 + CHUNK_SLOTS, g.pair_capacity) - 1;
    if (search && warp < 2) {
      const int c = warp_count_le(g.starts, g.n, warp == 0 ? k0 : k_last);
      if (lane == 0) s_count[warp] = c;
    }
    __syncthreads();
    const int total = s_total;
    if (k0 >= total) {   // every slot dead (total == 0 included: rank 0)
      const int kt = k0 + threadIdx.x * PER_THREAD;
      int key[PER_THREAD], gid[PER_THREAD];
      for (int j = 0; j < PER_THREAD; ++j) {
        key[j] = dead_key(g, kt + j);
        gid[j] = s_dead_id;
      }
      if (kt < g.pair_capacity) store4(g, kt, key, gid);
    } else {
      const int r_first = max(s_count[0] - 1, 0);
      const int r_last = k_last < total ? max(s_count[1] - 1, 0)
                                        : s_dead_rank;
      live_chunk(g, k0, total, r_first, r_last, s_start, s_x0, s_y0, s_w,
                 s_order, s_a);
    }
    chunk += gridDim.x;
    if (chunk >= chunks) break;
    search = chunk * CHUNK_SLOTS < total;
    __syncthreads();   // the window and the counts are free again
  }
}

}  // namespace

extern "C" int bs_expand_pairs(const int* starts_full, const int* x0,
                               const int* y0, const int* w, const int* order,
                               const float* atab, int n, int pair_capacity,
                               int gx, int tile, int kbits, int num_tiles,
                               int packed_key, int cull, int* key_out,
                               int* gauss_out, void* stream) {
  if (pair_capacity > 0) {
    // as many blocks as the card holds at once (looked up once a device)
    static int cached_device = -1, resident = 0;
    int device = 0;
    cudaError_t err = cudaGetDevice(&device);
    if (err != cudaSuccess) return (int)err;
    if (device != cached_device) {
      int sms = 0, per_sm = 0;
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
      if (err == cudaSuccess)
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, expand_pairs_kernel, THREADS, 0);
      if (err != cudaSuccess) return (int)err;
      resident = max(1, sms * per_sm);
      cached_device = device;
    }
    const Args g{starts_full, x0, y0, w, order, cull ? atab : nullptr, n,
                 pair_capacity, gx, tile, kbits, num_tiles, packed_key,
                 key_out, gauss_out};
    const int chunks = (pair_capacity + CHUNK_SLOTS - 1) / CHUNK_SLOTS;
    expand_pairs_kernel<<<min(chunks, resident), THREADS, 0,
                          (cudaStream_t)stream>>>(g);
  }
  return (int)cudaGetLastError();
}
