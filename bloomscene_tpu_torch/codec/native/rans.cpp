// rANS range coder with per-symbol 16-bit quantized CDF tables.
//
// The PyTorch port's copy of native/rans.cpp (the JAX package's coder),
// code unchanged, so the two packages write the same bytes: it replaces
// the reference's torchac CPU arithmetic coder (used at
// utils/encodings.py:107,132,151,172). The entropy model's CDF edges are
// computed here on the host from the context parameters; this coder turns
// symbols + CDFs into the bitstream at checkpoint boundaries only.
//
// Layout: state-32 rANS, 8-bit renormalization, encoding in reverse symbol
// order so decode streams forward. CDFs are per-symbol rows of K+1 uint16
// cumulative frequencies over a 2^16 total; every symbol must have nonzero
// mass (the python wrapper's quantizer guarantees it).
//
// C ABI for ctypes.

#include <cstdint>
#include <cstring>
#include <vector>

namespace {

constexpr uint32_t kProbBits = 16;
constexpr uint32_t kProbScale = 1u << kProbBits;   // 65536
constexpr uint32_t kRansL = 1u << 23;              // renorm lower bound

struct SymbolRange {
  uint32_t start;
  uint32_t freq;
};

inline SymbolRange lookup(const uint16_t* cdf_row, int sym) {
  uint32_t lo = cdf_row[sym];
  uint32_t hi = cdf_row[sym + 1];
  // row ends are implicit: index K holds 0 meaning 65536 when sym+1 == K
  if (hi == 0 && lo != 0) hi = kProbScale;
  return {lo, hi - lo};
}

}  // namespace

extern "C" {

// Encode n symbols. cdf: n rows of (num_cdf) uint16 each; symbols in
// [0, num_cdf-2]. out must hold worst case 4*n + 8 bytes. Returns the
// number of bytes written, or -1 on error.
int64_t rans_encode(const int32_t* symbols, const uint16_t* cdf,
                    int64_t n, int32_t num_cdf, uint8_t* out,
                    int64_t out_capacity) {
  std::vector<uint8_t> buf;
  buf.reserve(static_cast<size_t>(n) + 64);
  uint32_t state = kRansL;

  for (int64_t i = n - 1; i >= 0; --i) {
    const uint16_t* row = cdf + static_cast<size_t>(i) * num_cdf;
    int sym = symbols[i];
    if (sym < 0 || sym > num_cdf - 2) return -1;
    uint32_t lo = row[sym];
    uint32_t hi = (sym + 1 == num_cdf - 1) ? kProbScale : row[sym + 1];
    if (sym + 1 < num_cdf - 1 && row[sym + 1] == 0 && lo != 0)
      hi = kProbScale;
    uint32_t freq = hi - lo;
    if (freq == 0) return -2;

    // renormalize: state must stay < (kRansL >> kProbBits) << 8 * freq
    uint32_t x_max = ((kRansL >> kProbBits) << 8) * freq;
    while (state >= x_max) {
      buf.push_back(static_cast<uint8_t>(state & 0xFF));
      state >>= 8;
    }
    state = ((state / freq) << kProbBits) + (state % freq) + lo;
  }

  // flush 4 bytes of final state (little-endian), then the stream reversed
  int64_t total = static_cast<int64_t>(buf.size()) + 4;
  if (total > out_capacity) return -3;
  out[0] = state & 0xFF;
  out[1] = (state >> 8) & 0xFF;
  out[2] = (state >> 16) & 0xFF;
  out[3] = (state >> 24) & 0xFF;
  for (size_t j = 0; j < buf.size(); ++j)
    out[4 + j] = buf[buf.size() - 1 - j];
  return total;
}

// Decode n symbols from data (written by rans_encode with matching CDFs).
// Returns 0 on success.
int32_t rans_decode(const uint8_t* data, int64_t data_len,
                    const uint16_t* cdf, int64_t n, int32_t num_cdf,
                    int32_t* symbols_out) {
  if (data_len < 4) return -1;
  uint32_t state = static_cast<uint32_t>(data[0])
                 | (static_cast<uint32_t>(data[1]) << 8)
                 | (static_cast<uint32_t>(data[2]) << 16)
                 | (static_cast<uint32_t>(data[3]) << 24);
  int64_t pos = 4;

  for (int64_t i = 0; i < n; ++i) {
    const uint16_t* row = cdf + static_cast<size_t>(i) * num_cdf;
    uint32_t slot = state & (kProbScale - 1);

    // binary search for sym with cdf[sym] <= slot < cdf[sym+1]
    int lo_i = 0, hi_i = num_cdf - 2;
    while (lo_i < hi_i) {
      int mid = (lo_i + hi_i + 1) >> 1;
      uint32_t v = row[mid];
      if (mid < num_cdf - 1 && v == 0 && mid > 0) v = kProbScale;
      if (v <= slot) lo_i = mid; else hi_i = mid - 1;
    }
    int sym = lo_i;
    uint32_t start = row[sym];
    uint32_t hi = (sym + 1 == num_cdf - 1) ? kProbScale : row[sym + 1];
    if (sym + 1 < num_cdf - 1 && row[sym + 1] == 0 && start != 0)
      hi = kProbScale;
    uint32_t freq = hi - start;
    if (freq == 0) return -2;

    symbols_out[i] = sym;
    state = freq * (state >> kProbBits) + slot - start;
    while (state < kRansL) {
      if (pos >= data_len) {
        if (i == n - 1) break;  // final symbol may exactly drain the stream
        return -3;
      }
      state = (state << 8) | data[pos++];
    }
  }
  return 0;
}

}  // extern "C"

// ---------------- gaussian-conditioned coding, table-free ----------------
//
// The quantized CDF edge values of a gaussian row are independently
// computable: rows are strictly monotone by construction (monotone Phi,
// then a strictly increasing +j ramp), so no accumulate pass is needed and
// edge j is a pure function of (mean, sigma, q, min_v, j). Encoding then
// needs only TWO edge evaluations per symbol and decoding a ~log2(K)-step
// binary search — no [n, K+1] table is ever materialized. This removes the
// host codec's dominant cost (the reference's torchac path materializes
// full per-symbol CDF tables, utils/encodings.py:99-138).
//
// Phi is a linear-interp lookup into a table PASSED IN from python (the
// same buffer the python fallback uses), and this file is compiled with
// -ffp-contract=off, so C++ and numpy evaluate bit-identical edges.

namespace {

struct PhiLut {
  const double* table;   // [n+1] Phi samples over [z0, z1]
  double z0;
  double inv_h;          // n / (z1 - z0)
  double tmax;           // clamp bound, n * (1 - 1e-12)
};

// mirror of python _norm_cdf_fast: t = (z - z0) * inv_h, clamp, trunc,
// T[i] + (T[i+1] - T[i]) * f  — same operation order, no contraction
inline double phi_lut(const PhiLut& lut, double z) {
  double t = (z - lut.z0) * lut.inv_h;
  if (t < 0.0) t = 0.0;
  if (t > lut.tmax) t = lut.tmax;
  int64_t i = static_cast<int64_t>(t);
  double f = t - static_cast<double>(i);
  double a = lut.table[i];
  return a + (lut.table[i + 1] - a) * f;
}

struct GaussRow {
  double r1;        // q / sigma    (numpy: samples * (q/sigma)[:,None])
  double r2;        // mean / sigma
  double scale_k;   // kProbScale - K, as double for the rint product
  int32_t min_v;
  int32_t K;        // number of symbols (kp1 - 1)
};

// edge j of the quantized CDF, j in [0, K]; mirrors the python builder:
//   z = (min_v + j - 0.5) * (q/sigma) - mean/sigma
//   edge = rint(Phi(z) * (65536 - K)) + j ; edge_0 = 0 ; edge_K = 65536
inline uint32_t cdf_edge(const GaussRow& g, const PhiLut& lut, int32_t j) {
  if (j <= 0) return 0;
  if (j >= g.K) return kProbScale;
  double s = static_cast<double>(g.min_v + j) - 0.5;
  double z = s * g.r1 - g.r2;
  double c = phi_lut(lut, z);
  return static_cast<uint32_t>(__builtin_rint(c * g.scale_k))
         + static_cast<uint32_t>(j);
}

}  // namespace

extern "C" {

// Encode n symbols (already offset to [0, K-1]) against per-symbol
// gaussians, quantized-CDF edges computed on the fly. Returns bytes
// written or <0 on error.
int64_t rans_encode_gaussian(const int32_t* symbols, const double* mean,
                             const double* sigma, const double* q,
                             int64_t n, int32_t min_v, int32_t num_sym,
                             const double* phi_table, int64_t phi_n,
                             double phi_z0, double phi_inv_h,
                             double phi_tmax,
                             uint8_t* out, int64_t out_capacity) {
  PhiLut lut{phi_table, phi_z0, phi_inv_h, phi_tmax};
  const double scale_k =
      static_cast<double>(kProbScale - static_cast<uint32_t>(num_sym));
  std::vector<uint8_t> buf;
  buf.reserve(static_cast<size_t>(n) + 64);
  uint32_t state = kRansL;

  for (int64_t i = n - 1; i >= 0; --i) {
    int32_t sym = symbols[i];
    if (sym < 0 || sym > num_sym - 1) return -1;
    GaussRow g{q[i] / sigma[i], mean[i] / sigma[i], scale_k, min_v, num_sym};
    uint32_t lo = cdf_edge(g, lut, sym);
    uint32_t freq = cdf_edge(g, lut, sym + 1) - lo;
    if (freq == 0) return -2;
    uint32_t x_max = ((kRansL >> kProbBits) << 8) * freq;
    while (state >= x_max) {
      buf.push_back(static_cast<uint8_t>(state & 0xFF));
      state >>= 8;
    }
    state = ((state / freq) << kProbBits) + (state % freq) + lo;
  }

  int64_t total = static_cast<int64_t>(buf.size()) + 4;
  if (total > out_capacity) return -3;
  out[0] = state & 0xFF;
  out[1] = (state >> 8) & 0xFF;
  out[2] = (state >> 16) & 0xFF;
  out[3] = (state >> 24) & 0xFF;
  for (size_t j = 0; j < buf.size(); ++j)
    out[4 + j] = buf[buf.size() - 1 - j];
  return total;
}

// Decode n symbols written by rans_encode_gaussian (same params).
// symbols_out receives values in [0, K-1]. Returns 0 on success.
int32_t rans_decode_gaussian(const uint8_t* data, int64_t data_len,
                             const double* mean, const double* sigma,
                             const double* q, int64_t n, int32_t min_v,
                             int32_t num_sym,
                             const double* phi_table, int64_t phi_n,
                             double phi_z0, double phi_inv_h,
                             double phi_tmax,
                             int32_t* symbols_out) {
  if (data_len < 4) return -1;
  PhiLut lut{phi_table, phi_z0, phi_inv_h, phi_tmax};
  const double scale_k =
      static_cast<double>(kProbScale - static_cast<uint32_t>(num_sym));
  uint32_t state = static_cast<uint32_t>(data[0])
                 | (static_cast<uint32_t>(data[1]) << 8)
                 | (static_cast<uint32_t>(data[2]) << 16)
                 | (static_cast<uint32_t>(data[3]) << 24);
  int64_t pos = 4;

  for (int64_t i = 0; i < n; ++i) {
    GaussRow g{q[i] / sigma[i], mean[i] / sigma[i], scale_k, min_v, num_sym};
    uint32_t slot = state & (kProbScale - 1);
    // largest sym in [0, K-1] with edge(sym) <= slot
    int32_t lo_i = 0, hi_i = num_sym - 1;
    while (lo_i < hi_i) {
      int32_t mid = (lo_i + hi_i + 1) >> 1;
      if (cdf_edge(g, lut, mid) <= slot) lo_i = mid; else hi_i = mid - 1;
    }
    int32_t sym = lo_i;
    uint32_t start = cdf_edge(g, lut, sym);
    uint32_t freq = cdf_edge(g, lut, sym + 1) - start;
    if (freq == 0) return -2;
    symbols_out[i] = sym;
    state = freq * (state >> kProbBits) + slot - start;
    while (state < kRansL) {
      if (pos >= data_len) {
        if (i == n - 1) break;
        return -3;
      }
      state = (state << 8) | data[pos++];
    }
  }
  return 0;
}

}  // extern "C"
