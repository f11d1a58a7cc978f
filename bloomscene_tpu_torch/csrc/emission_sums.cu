// emission_sums -- the blend backward's emission-order reduction: K2's
// per-entry gradients summed over each Gaussian's contiguous range of
// emission slots.
//
// No TPU kernel is replaced: the JAX package does this outside its Pallas
// kernels, as XLA's gather, cumsum and difference
// (bloomscene_tpu/ops/pallas/wrapper.py:146-172). That form, in torch,
// writes five [10, pc] intermediates of 84 MB each at the pair capacity
// pc = 2^21 and scans them with a library scan that spreads 10 rows over
// few blocks: ~3.7 ms a step. Here each Gaussian's range is read where it
// lies, with no scan and no intermediate, so the prefix sum's cancellation
// noise (eps * |prefix|) goes too.
//
// What it computes: grad [10, n_lanes] (K2's [10, cap, T] flattened),
// src_lane [pc] (the lane of each emission slot; n_lanes for a dead one:
// culled, truncated or over capacity), starts, ends [n] (each Gaussian's
// emission range, clamped here to pc) ->
//   out[c, i] = sum over k in [min(s_i, pc), min(e_i, pc)) with
//               src_lane[k] < n_lanes of grad[c, src_lane[k]],
// 0 where the range is empty.
//
// What bounds it on an H100: bytes -- the [10, n] sums written once, the
// ranges read once, src_lane read over the ranges and ten 4-byte gathers
// of grad a live pair. K2 has just written grad, ~42 MB at the main path's
// shape, so most of its gathers hit the 50 MB L2.
//
// The design: a thread a Gaussian, a warp 32 consecutive Gaussians. A
// range of at most WARP_RANGE slots is summed by its own thread, in slot
// order from 0 (index_add's sequential order, so the plain version's bits).
// A longer one (a splat over many tiles) is summed by the whole warp
// together, so it does not hold the warp for hundreds of serial rounds of
// scattered loads: the warp's long ranges are taken one after another in
// lane order (a ballot); lane l adds slots l, l + 32, ... in order from 0,
// and the 32 partials are combined by a fixed butterfly of shuffles. The
// order of every addition follows from the ranges alone: no atomics, the
// same bits from one launch to the next. Every output element is written
// once (no memset), the grid follows from n alone and the kernel reads
// nothing back to the host and allocates nothing, so a CUDA graph
// captures it.
#include <cuda_runtime.h>

namespace {

constexpr int CH = 10;          // gradient channels (K2's GRAD_W)
constexpr int BLOCK = 256;
constexpr int WARP_RANGE = 16;  // a longer range is summed by its warp
constexpr unsigned FULL = 0xffffffffu;

__global__ void __launch_bounds__(BLOCK)
    emission_sums(const float* __restrict__ grad, int n_lanes,
                  const int* __restrict__ src_lane, int pc,
                  const int* __restrict__ starts,
                  const int* __restrict__ ends, int n,
                  float* __restrict__ out) {
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  const int lane = threadIdx.x & 31;
  int s = 0, e = 0;
  if (i < n) {
    s = min(starts[i], pc);
    e = max(s, min(ends[i], pc));
  }
  float acc[CH];
#pragma unroll
  for (int c = 0; c < CH; ++c) acc[c] = 0.0f;
  const bool wide = e - s > WARP_RANGE;
  if (!wide) {
    for (int k = s; k < e; ++k) {
      const int l = __ldg(src_lane + k);
      if (l < n_lanes) {
#pragma unroll
        for (int c = 0; c < CH; ++c)
          acc[c] += __ldg(grad + (size_t)c * n_lanes + l);
      }
    }
  }
  // every lane reaches the ballot: threads past n hold an empty range
  unsigned todo = __ballot_sync(FULL, wide);
  while (todo) {
    const int j = __ffs(todo) - 1;
    todo &= todo - 1;
    const int sj = __shfl_sync(FULL, s, j);
    const int ej = __shfl_sync(FULL, e, j);
    float part[CH];
#pragma unroll
    for (int c = 0; c < CH; ++c) part[c] = 0.0f;
    for (int k = sj + lane; k < ej; k += 32) {
      const int l = __ldg(src_lane + k);
      if (l < n_lanes) {
#pragma unroll
        for (int c = 0; c < CH; ++c)
          part[c] += __ldg(grad + (size_t)c * n_lanes + l);
      }
    }
    // a butterfly: each lane adds the same pairs, so all end equal
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int c = 0; c < CH; ++c)
        part[c] += __shfl_xor_sync(FULL, part[c], off);
    }
    if (lane == j) {
#pragma unroll
      for (int c = 0; c < CH; ++c) acc[c] = part[c];
    }
  }
  if (i < n) {
#pragma unroll
    for (int c = 0; c < CH; ++c) out[(size_t)c * n + i] = acc[c];
  }
}

}  // namespace

// grad [CH, n_lanes] float32; src_lane [pc] int32 in [0, n_lanes];
// starts, ends [n] int32 >= 0; out [CH, n] float32, written whole.
extern "C" int bs_emission_sums(const float* grad, long long n_lanes,
                                const int* src_lane, long long pc,
                                const int* starts, const int* ends,
                                long long n, float* out, void* stream) {
  if (n_lanes < 1 || n_lanes >= (1LL << 31) || pc < 0 || pc >= (1LL << 31) ||
      n < 1 || n >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + BLOCK - 1) / BLOCK);
  emission_sums<<<blocks, BLOCK, 0, (cudaStream_t)stream>>>(
      grad, (int)n_lanes, src_lane, (int)pc, starts, ends, (int)n, out);
  return (int)cudaGetLastError();
}
