// hashgrid_bwd -- the hash grid's backward: a fixed-order segmented sum of
// the corner gathers' cotangent rows into the table.
//
// No TPU kernel is replaced: the JAX package's hash grid is pure jnp
// (bloomscene_tpu/ops/hashgrid.py), and XLA's scatter-add does this work
// there. On the card, the backward of the corner gathers was
// ``index_add_``, whose atomic float adds land in no fixed order, so two
// identical phase-2 steps gave different table gradients.
//
// What it computes: out[keys[i]] += rows[order[i]] over the M entries of
// one encoder (every level and corner of every anchor), where ``keys`` is
// the entries' table cells sorted stably and ``order`` the sort's
// permutation, both from torch.sort(stable=True) in the wrapper. ``out``
// [S, F] comes in zeroed; cells no entry names stay 0.
//
// The order of every sum is fixed by the sorted list, so two launches give
// the same bits:
// - pass 1, one thread per chunk of CHUNK consecutive sorted entries, adds
//   each run of equal keys in list order. A run that begins and ends
//   inside the chunk is written to its cell; the chunk's first run, when
//   it began in an earlier chunk, goes to partial slot 0, and its last
//   run, when it goes on into the next chunk, to slot 1 (a chunk that is
//   one run throughout uses slot 0 only);
// - pass 2, one thread per chunk whose last run goes on past it and
//   begins in it, adds that run's pieces in chunk order and writes the
//   cell.
// The trap a one-thread-per-run design falls into: every dead anchor sits
// at one point, so one cell of every level and corner holds a run of
// ~28K entries in a training step. Here such a run is spread over
// ~28K / CHUNK threads in pass 1, and pass 2 adds one partial per chunk.
//
// What bounds it on an H100: bytes -- per entry 4 bytes of key, 8 of order
// and 4 F bytes of row read once, and the table written once; ~F adds an
// entry. The row reads follow the sorted order, so they are gathers, and
// a row's address waits on its order entry: a pass-1 thread issues the
// loads of BATCH entries together before it adds them in order.
#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 64;      // sorted entries a pass-1 thread adds
constexpr int BATCH = 8;       // entries whose loads a thread issues at once
constexpr int MAX_F = 8;       // features a cell row holds, at most
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS) chunk_sums(
    const int* __restrict__ keys, const long long* __restrict__ order,
    const float* __restrict__ rows, long long M, int F,
    float* __restrict__ part, float* __restrict__ out) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long lo = c * CHUNK;
  if (lo >= M) return;
  const long long hi = min(lo + CHUNK, M);
  // the chunk's first run began here; its last run ends here
  const bool head_starts = lo == 0 || keys[lo - 1] != keys[lo];
  const bool tail_ends = hi == M || keys[hi] != keys[hi - 1];
  float acc[MAX_F];
#pragma unroll
  for (int f = 0; f < MAX_F; ++f) acc[f] = 0.0f;
  int key = keys[lo];
  bool first = true;
  auto emit = [&](bool last) {
    float* dst;
    if ((!first || head_starts) && (!last || tail_ends))
      dst = out + (long long)key * F;           // a whole run: its cell
    else
      dst = part + (c * 2 + (first ? 0 : 1)) * F;
#pragma unroll
    for (int f = 0; f < MAX_F; ++f)
      if (f < F) dst[f] = acc[f];
  };
  // BATCH entries at a time: their keys and rows are loaded first (the
  // loads in flight together), then added one by one in list order
  for (long long base = lo; base < hi; base += BATCH) {
    const int nb = (int)min((long long)BATCH, hi - base);
    int k[BATCH];
    long long src[BATCH];
    float v[BATCH][MAX_F];
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      k[j] = j < nb ? keys[base + j] : key;
      src[j] = j < nb ? order[base + j] : 0;
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      const float* r = rows + src[j] * F;
#pragma unroll
      for (int f = 0; f < MAX_F; ++f)
        v[j][f] = (j < nb && f < F) ? r[f] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < BATCH; ++j) {
      if (j >= nb) break;
      if (k[j] != key) {
        emit(false);
#pragma unroll
        for (int f = 0; f < MAX_F; ++f) acc[f] = 0.0f;
        key = k[j];
        first = false;
      }
#pragma unroll
      for (int f = 0; f < MAX_F; ++f)
        if (f < F) acc[f] = acc[f] + v[j][f];
    }
  }
  emit(true);
}

__global__ void __launch_bounds__(THREADS) run_sums(
    const int* __restrict__ keys, long long M, int F,
    const float* __restrict__ part, float* __restrict__ out) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long lo = c * CHUNK;
  if (lo >= M) return;
  const long long hi = min(lo + CHUNK, M);
  const int key = keys[hi - 1];
  if (hi == M || keys[hi] != key) return;       // the last run ends here
  const bool one_run = keys[lo] == key;
  if (one_run && lo > 0 && keys[lo - 1] == key) return;  // began earlier
  float acc[MAX_F];
  const float* p = part + (c * 2 + (one_run ? 0 : 1)) * F;
#pragma unroll
  for (int f = 0; f < MAX_F; ++f) acc[f] = f < F ? p[f] : 0.0f;
  // the following chunks' first runs, in chunk order, while the run goes on
  for (long long d = c + 1;; ++d) {
    const float* q = part + d * 2 * F;
#pragma unroll
    for (int f = 0; f < MAX_F; ++f)
      if (f < F) acc[f] = acc[f] + q[f];
    const long long end = min((d + 1) * CHUNK, M);
    if (end == M || keys[end - 1] != key || keys[end] != key) break;
  }
  float* dst = out + (long long)key * F;
#pragma unroll
  for (int f = 0; f < MAX_F; ++f)
    if (f < F) dst[f] = acc[f];
}

}  // namespace

// keys [M] int32 sorted, order [M] int64, rows [M, F] float32, part
// [ceil(M / CHUNK), 2, F] float32 scratch, out [S, F] float32 zeroed.
extern "C" int bs_hashgrid_bwd(const int* keys, const long long* order,
                               const float* rows, long long M, int F,
                               float* part, float* out, void* stream) {
  if (F < 1 || F > MAX_F) return (int)cudaErrorInvalidValue;
  if (M > 0) {
    const long long chunks = (M + CHUNK - 1) / CHUNK;
    const unsigned blocks = (unsigned)((chunks + THREADS - 1) / THREADS);
    chunk_sums<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
        keys, order, rows, M, F, part, out);
    run_sums<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(keys, M, F, part,
                                                           out);
  }
  return (int)cudaGetLastError();
}
