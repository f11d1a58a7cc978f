// gather_rows_bwd -- the backward of the compacted decode's row gather: a
// fixed-order segmented sum over a sorted index.
//
// No TPU kernel is replaced: the JAX package gathers the visible anchors'
// rows with jnp indexing (bloomscene_tpu/models/anchors.py, gather_rows),
// and XLA's scatter-add is its transpose. On the card, torch's backward of
// ``x[idx]`` (index_put_ with accumulate) sorts the entries and walks each
// run of one row serially; compact_visible pads its bucket with row C - 1,
// so one run holds most of the entries, and that walk took most of a
// compacted training step.
//
// What it computes, for each of up to MAX_LEAVES leaves j with a cotangent
// g_j [V, k_j]: out_j [C, k_j], out_j[r] = sum of g_j[i] over idx[i] == r,
// rows no entry names 0.
// The precondition: idx is nondecreasing and in [0, C) (compact_visible's
// index is by construction); the kernel does not check it.
//
// What bounds it on an H100: bytes -- each entry's index (8 bytes) and
// K = sum k_j floats read once, each output row written once; one add an
// entry and column.
//
// The design. The leaves' columns are one space of K columns (a table of
// pointers, one launch for all of them), a thread a column.
// 0. The outputs are zeroed (cudaMemsetAsync): in the compacted decode most
//    rows are named by no entry (~130K of 139,264 rows, the padding holding
//    ~122K of the 131,072 entries), so this is most of the bytes written.
// 1. chunk_sums: a block takes CHUNK consecutive entries; each thread adds
//    its column down the chunk in entry order from 0, and where a run
//    ends it writes the sum: straight to the output row when the run lies
//    wholly in the chunk, else to the chunk's partial (slot 0: the run came
//    from the chunk before; slot 1: it goes on into the next one).
// 2. run_sums: the chunk holding a crossing run's first entry finds the
//    run's last chunk (a binary search of idx) and adds the run's fragments
//    (its own slot 1, then the next chunks' slot 0) in chunk order: GROUPS
//    groups of threads each add a contiguous share of the fragments from 0,
//    then the groups' sums are added in group order.
// A row whose run has one entry gets 0 + g, torch's sum; every order is
// fixed by V alone, so two launches give the same bits, with no atomics.
// A run longer than one entry is summed in another association than
// torch's sequential walk; it is the same bits where all but one of the
// run's entries are zeros (the padding's cotangents are).
#include <cuda_runtime.h>

namespace {

constexpr int MAX_LEAVES = 8;
constexpr int CHUNK = 256;      // entries a block of chunk_sums adds
constexpr int THREADS = 128;    // chunk_sums: one column a thread
constexpr int UNROLL = 8;       // entries loaded ahead in chunk_sums
constexpr int GROUPS = 8;       // run_sums: GROUPS x THREADS threads

// the leaves as one space of K columns
struct Leaves {
  const float* g[MAX_LEAVES];   // [V, k] cotangents
  float* out[MAX_LEAVES];       // [C, k] sums
  int k[MAX_LEAVES];
  int col0[MAX_LEAVES + 1];     // first column of each leaf; col0[n] = K
  int n;
};

__device__ __forceinline__ int leaf_of(const Leaves& L, int c) {
  int j = 0;
  while (c >= L.col0[j + 1]) ++j;
  return j;
}

// one block a chunk; s_idx holds idx[base - 1 .. base + n] (-1 before the
// first entry and -2 after the last: values no entry has)
__global__ void __launch_bounds__(THREADS) chunk_sums(
    const long long* __restrict__ idx, long long V, int K, Leaves L,
    float* __restrict__ part) {
  __shared__ long long s_idx[CHUNK + 2];
  const long long base = (long long)blockIdx.x * CHUNK;
  const int n = (int)(V - base < CHUNK ? V - base : CHUNK);
  for (int i = threadIdx.x; i < n; i += THREADS) s_idx[i + 1] = idx[base + i];
  if (threadIdx.x == 0) {
    s_idx[0] = base > 0 ? idx[base - 1] : -1;
    s_idx[n + 1] = base + n < V ? idx[base + n] : -2;
  }
  __syncthreads();
  for (int c = threadIdx.x; c < K; c += THREADS) {
    const int j = leaf_of(L, c);
    const int k = L.k[j], cc = c - L.col0[j];
    const float* __restrict__ g = L.g[j] + base * k + cc;
    float* __restrict__ out = L.out[j] + cc;
    float acc = 0.0f;
    for (int i0 = 0; i0 < n; i0 += UNROLL) {
      float v[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
        v[u] = i0 + u < n ? g[(long long)(i0 + u) * k] : 0.0f;
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int i = i0 + u;
        if (i >= n) break;
        const long long r = s_idx[i + 1];
        acc = acc + v[u];
        if (r != s_idx[i + 2] || i == n - 1) {  // its last entry here
          const bool from_prev = r == s_idx[0];
          const bool to_next = i == n - 1 && r == s_idx[n + 1];
          if (!from_prev && !to_next)
            out[r * k] = acc;
          else
            part[((long long)blockIdx.x * 2 + (from_prev ? 0 : 1)) * K + c] =
                acc;
          acc = 0.0f;
        }
      }
    }
  }
}

// one block a chunk: the chunk holding a crossing run's first entry adds
// the run's fragments in chunk order
__global__ void __launch_bounds__(GROUPS * THREADS) run_sums(
    const long long* __restrict__ idx, long long V, int n_chunks, int K,
    Leaves L, const float* __restrict__ part) {
  __shared__ float s_sum[GROUPS][THREADS];
  const int ch = blockIdx.x;
  if (ch >= n_chunks - 1) return;  // the last chunk's runs end in it
  const long long last = (long long)ch * CHUNK + CHUNK - 1;
  const long long r = idx[last];
  if (idx[last + 1] != r) return;                            // ends here
  if (ch > 0 && idx[(long long)ch * CHUNK - 1] == r) return;  // not first
  long long lo = last + 1, hi = V;  // the first entry past the run
  while (lo < hi) {
    const long long mid = lo + (hi - lo) / 2;
    if (idx[mid] <= r) lo = mid + 1; else hi = mid;
  }
  // fragment t: t = 0 the chunk's slot 1, t > 0 chunk ch + t's slot 0
  const int m = (int)((lo - 1) / CHUNK) - ch + 1;
  const int grp = threadIdx.x / THREADS, tc = threadIdx.x % THREADS;
  const int per = (m + GROUPS - 1) / GROUPS;
  const int t0 = grp * per, t1 = min(m, t0 + per);
  for (int c0 = 0; c0 < K; c0 += THREADS) {
    const int c = c0 + tc;
    if (c < K) {
      float acc = 0.0f;
#pragma unroll 4
      for (int t = t0; t < t1; ++t)
        acc = acc + part[((long long)(ch + t) * 2 + (t == 0 ? 1 : 0)) * K + c];
      s_sum[grp][tc] = acc;
    }
    __syncthreads();
    if (grp == 0 && c < K) {
      float acc = 0.0f;
#pragma unroll
      for (int q = 0; q < GROUPS; ++q) acc = acc + s_sum[q][tc];
      const int j = leaf_of(L, c);
      L.out[j][r * L.k[j] + (c - L.col0[j])] = acc;
    }
    __syncthreads();
  }
}

long long n_chunks_of(long long V) { return (V + CHUNK - 1) / CHUNK; }

}  // namespace

// The float workspace a call needs: two partial rows of K floats a chunk.
extern "C" int bs_gather_rows_bwd_workspace(long long V, int K,
                                            long long* n_float) {
  if (V < 0 || V >= (1LL << 31) || K < 1) return (int)cudaErrorInvalidValue;
  *n_float = n_chunks_of(V) * 2 * K;
  return 0;
}

// idx [V] int64 nondecreasing in [0, C); g[j] [V, k[j]] float32 and out[j]
// [C, k[j]] float32 for the n leaves (host arrays of device pointers); ws
// the workspace of bs_gather_rows_bwd_workspace.
extern "C" int bs_gather_rows_bwd(const long long* idx, long long V,
                                  long long C, int n, const float* const* g,
                                  float* const* out, const int* k, float* ws,
                                  void* stream) {
  if (n < 1 || n > MAX_LEAVES || V < 1 || V >= (1LL << 31) || C < 1 ||
      C >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Leaves L{};
  L.n = n;
  int K = 0;
  for (int j = 0; j < n; ++j) {
    if (k[j] < 1) return (int)cudaErrorInvalidValue;
    L.g[j] = g[j];
    L.out[j] = out[j];
    L.k[j] = k[j];
    L.col0[j] = K;
    K += k[j];
  }
  for (int j = n; j <= MAX_LEAVES; ++j) L.col0[j] = K;
  const auto st = (cudaStream_t)stream;
  for (int j = 0; j < n; ++j) {
    const cudaError_t e =
        cudaMemsetAsync(out[j], 0, sizeof(float) * C * k[j], st);
    if (e != cudaSuccess) return (int)e;
  }
  const long long chunks = n_chunks_of(V);
  chunk_sums<<<(unsigned)chunks, THREADS, 0, st>>>(idx, V, K, L, ws);
  run_sums<<<(unsigned)chunks, GROUPS * THREADS, 0, st>>>(idx, V, (int)chunks,
                                                          K, L, ws);
  return (int)cudaGetLastError();
}
