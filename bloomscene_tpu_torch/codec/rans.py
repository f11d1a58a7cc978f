"""rANS entropy coder: ctypes bindings to the native C++ coder, and the
pure-Python coder as its plain version.

The port's copy of ``bloomscene_tpu/codec/rans.py`` (which replaces the
reference's torchac, utils/encodings.py:84-174), writing the same bytes
for the same symbols and float64 parameters. The native library is
``codec/native/rans.cpp`` built with g++ at first use into
``bloomscene_tpu_torch/build/librans_<digest>.so`` (the digest covers the
source and the flags, so an edited source rebuilds; a build writes a
temporary name and renames it into place, so concurrent processes do not
race). A failed build raises: there is no silent fallback. The
pure-Python coder is selected by ``native=False`` and serves the tests,
which hold the native coder to it byte for byte.

API, as the scene codec needs it:
- ``encode_with_cdf(symbols, cdf_float)`` / ``decode_with_cdf``: per-symbol
  float CDF rows (like torchac.encode_float_cdf);
- ``encode_gaussian`` / ``decode_gaussian``: gaussian-conditioned coding of
  quantized values (reference encoder_gaussian/decoder_gaussian,
  encodings.py:84-138);
- ``encode_binary`` / ``decode_binary``: Bernoulli coding of {-1,+1} or
  {0,1} arrays (reference encoder/decoder, encodings.py:141-174).

The normal CDF table that conditions the gaussian streams is computed
with cephes' ``ndtr`` (erf and erfc as rational approximations), written
here in Python, so the table has the bits of ``scipy.special.ndtr`` that
the JAX package's table takes, without scipy.
"""
from __future__ import annotations

import ctypes
import hashlib
import math
import os
import struct
import subprocess
from pathlib import Path

import numpy as np

_PROB_BITS = 16
_PROB_SCALE = 1 << _PROB_BITS

SOURCE = Path(__file__).resolve().parent / "native" / "rans.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build"
# -ffp-contract=off: the gaussian fast path recomputes CDF edges that must
# be bit-identical to numpy's (no FMA fusion)
GXX_FLAGS = ("-O3", "-ffp-contract=off", "-shared", "-fPIC")

_lib = None


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()
                            + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"librans_{digest}.so"


def _native_lib() -> ctypes.CDLL:
    """The loaded native coder, built first if missing; raises if g++
    fails."""
    global _lib
    if _lib is not None:
        return _lib
    so = library_path()
    if not so.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        try:
            subprocess.run(["g++", *GXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                           check=True, capture_output=True, text=True)
        except (OSError, subprocess.CalledProcessError) as e:
            tmp.unlink(missing_ok=True)
            detail = getattr(e, "stderr", "") or str(e)
            raise RuntimeError(f"building the rANS coder failed: {detail}")
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    i32p, u16p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_uint16)
    u8p, dblp = ctypes.POINTER(ctypes.c_uint8), ctypes.POINTER(ctypes.c_double)
    lib.rans_encode.restype = ctypes.c_int64
    lib.rans_encode.argtypes = [i32p, u16p, ctypes.c_int64, ctypes.c_int32,
                                u8p, ctypes.c_int64]
    lib.rans_decode.restype = ctypes.c_int32
    lib.rans_decode.argtypes = [u8p, ctypes.c_int64, u16p, ctypes.c_int64,
                                ctypes.c_int32, i32p]
    gauss = [dblp, dblp, dblp, ctypes.c_int64, ctypes.c_int32,
             ctypes.c_int32, dblp, ctypes.c_int64, ctypes.c_double,
             ctypes.c_double, ctypes.c_double]
    lib.rans_encode_gaussian.restype = ctypes.c_int64
    lib.rans_encode_gaussian.argtypes = [i32p, *gauss, u8p, ctypes.c_int64]
    lib.rans_decode_gaussian.restype = ctypes.c_int32
    lib.rans_decode_gaussian.argtypes = [u8p, ctypes.c_int64, *gauss, i32p]
    _lib = lib
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def quantize_cdf(cdf_float: np.ndarray) -> np.ndarray:
    """Float CDF rows [N, K+1] in [0,1] -> uint16 rows with strictly
    increasing values, 0 start, total 2^16 (final entry stored as 0).

    Same guarantee scheme as torchac: each symbol keeps >= 1/2^16 mass.
    """
    cdf_float = np.asarray(cdf_float, np.float64)
    n, kp1 = cdf_float.shape
    k = kp1 - 1
    cdf = np.clip(cdf_float, 0.0, 1.0)
    cdf = np.maximum.accumulate(cdf, axis=1)
    # scale to (2^16 - K) then add ramp to force strict monotonicity
    q = np.round(cdf * (_PROB_SCALE - k)).astype(np.int64)
    q = q + np.arange(kp1, dtype=np.int64)[None, :]
    q[:, 0] = 0
    q[:, -1] = _PROB_SCALE
    q = np.maximum.accumulate(q, axis=1)
    return (q & 0xFFFF).astype(np.uint16)   # 65536 -> 0 in the last entry


# ---------------- the pure-Python coder (plain version) ----------------

def _row_bounds(row: np.ndarray, sym: int, k: int):
    lo = int(row[sym])
    hi = _PROB_SCALE if sym + 1 == k else int(row[sym + 1])
    if hi == 0 and lo != 0:
        hi = _PROB_SCALE
    return lo, hi - lo


def _py_encode(symbols: np.ndarray, cdf_q: np.ndarray) -> bytes:
    n, kp1 = cdf_q.shape
    k = kp1 - 1
    L = 1 << 23
    state = L
    out = bytearray()
    for i in range(n - 1, -1, -1):
        lo, freq = _row_bounds(cdf_q[i], int(symbols[i]), k)
        x_max = ((L >> _PROB_BITS) << 8) * freq
        while state >= x_max:
            out.append(state & 0xFF)
            state >>= 8
        state = ((state // freq) << _PROB_BITS) + (state % freq) + lo
    head = state.to_bytes(4, 'little')
    return head + bytes(reversed(out))


def _py_decode(data: bytes, cdf_q: np.ndarray, n: int) -> np.ndarray:
    kp1 = cdf_q.shape[1]
    k = kp1 - 1
    L = 1 << 23
    state = int.from_bytes(data[:4], 'little')
    pos = 4
    out = np.empty(n, np.int32)
    for i in range(n):
        slot = state & (_PROB_SCALE - 1)
        row = cdf_q[i]
        lo_i, hi_i = 0, k - 1
        while lo_i < hi_i:
            mid = (lo_i + hi_i + 1) >> 1
            v = int(row[mid])
            if mid < k and v == 0 and mid > 0:
                v = _PROB_SCALE
            if v <= slot:
                lo_i = mid
            else:
                hi_i = mid - 1
        sym = lo_i
        lo, freq = _row_bounds(row, sym, k)
        out[i] = sym
        state = freq * (state >> _PROB_BITS) + slot - lo
        while state < L and pos < len(data):
            state = (state << 8) | data[pos]
            pos += 1
    return out


# ---------------- public API ----------------

def _encode_q(symbols: np.ndarray, cdf_q: np.ndarray,
              native: bool = True) -> bytes:
    """symbols int32 [N] + PRE-QUANTIZED uint16 rows -> bitstream."""
    symbols = np.ascontiguousarray(symbols, np.int32)
    cdf_q = np.ascontiguousarray(cdf_q)
    n, kp1 = cdf_q.shape
    assert symbols.shape == (n,)
    if not native:
        return _py_encode(symbols, cdf_q)
    out = np.empty(4 * n + 64, np.uint8)
    written = _native_lib().rans_encode(
        _ptr(symbols, ctypes.c_int32), _ptr(cdf_q, ctypes.c_uint16), n, kp1,
        _ptr(out, ctypes.c_uint8), out.size)
    if written < 0:
        raise ValueError(f"rans_encode failed: {written}")
    return out[:written].tobytes()


def _decode_q(data: bytes, cdf_q: np.ndarray,
              native: bool = True) -> np.ndarray:
    cdf_q = np.ascontiguousarray(cdf_q)
    n, kp1 = cdf_q.shape
    if not native:
        return _py_decode(data, cdf_q, n)
    buf = np.frombuffer(data, np.uint8)
    out = np.empty(n, np.int32)
    rc = _native_lib().rans_decode(
        _ptr(buf, ctypes.c_uint8), buf.size, _ptr(cdf_q, ctypes.c_uint16), n,
        kp1, _ptr(out, ctypes.c_int32))
    if rc != 0:
        raise ValueError(f"rans_decode failed: {rc}")
    return out


def encode_with_cdf(symbols: np.ndarray, cdf_float: np.ndarray,
                    native: bool = True) -> bytes:
    """symbols int [N], cdf_float [N, K+1] -> bitstream bytes."""
    return _encode_q(symbols, quantize_cdf(cdf_float), native)


def decode_with_cdf(data: bytes, cdf_float: np.ndarray,
                    native: bool = True) -> np.ndarray:
    """bitstream + the same CDF rows -> symbols int32 [N]."""
    return _decode_q(data, quantize_cdf(cdf_float), native)


# cephes ndtr (erf and erfc as rational approximations), the function
# scipy.special.ndtr evaluates; in float64, operation for operation
_ERFC_P = (2.46196981473530512524E-10, 5.64189564831068821977E-1,
           7.46321056442269912687E0, 4.86371970985681366614E1,
           1.96520832956077098242E2, 5.26445194995477358631E2,
           9.34528527171957607540E2, 1.02755188689515710272E3,
           5.57535335369399327526E2)
_ERFC_Q = (1.32281951154744992508E1, 8.67072140885989742329E1,
           3.54937778887819891062E2, 9.75708501743205489753E2,
           1.82390916687909736289E3, 2.24633760818710981792E3,
           1.65666309194161350182E3, 5.57535340817727675546E2)
_ERFC_R = (5.64189583547755073984E-1, 1.27536670759978104416E0,
           5.01905042251180477414E0, 6.16021097993053585195E0,
           7.40974269950448939160E0, 2.97886665372100240670E0)
_ERFC_S = (2.26052863220117276590E0, 9.39603524938001434673E0,
           1.20489539808096656605E1, 1.70814450747565897222E1,
           9.60896809063285878198E0, 3.36907645100081516050E0)
_ERF_T = (9.60497373987051638749E0, 9.00260197203842689217E1,
          2.23200534594684319226E3, 7.00332514112805075473E3,
          5.55923013010394962768E4)
_ERF_U = (3.35617141647503099647E1, 5.21357949780152679795E2,
          4.59432382970980127987E3, 2.26290000613890934246E4,
          4.92673942608635921086E4)
_MAXLOG = 7.09782712893383996843E2
_SQRT1_2 = 0.70710678118654752440


def _polevl(x: float, c) -> float:
    a = c[0]
    for ci in c[1:]:
        a = a * x + ci
    return a


def _p1evl(x: float, c) -> float:
    """_polevl with a leading coefficient of 1."""
    a = x + c[0]
    for ci in c[1:]:
        a = a * x + ci
    return a


def _erf(x: float) -> float:
    if abs(x) > 1.0:
        return 1.0 - _erfc(x)
    z = x * x
    return x * _polevl(z, _ERF_T) / _p1evl(z, _ERF_U)


def _erfc(a: float) -> float:
    x = -a if a < 0 else a
    if x < 1.0:
        return 1.0 - _erf(a)
    z = -a * a
    if z < -_MAXLOG:
        return 2.0 if a < 0 else 0.0
    z = math.exp(z)
    if x < 8.0:
        p, q = _polevl(x, _ERFC_P), _p1evl(x, _ERFC_Q)
    else:
        p, q = _polevl(x, _ERFC_R), _p1evl(x, _ERFC_S)
    y = (z * p) / q
    if a < 0:
        y = 2.0 - y
    if y == 0.0:
        return 2.0 if a < 0 else 0.0
    return y


def ndtr(a: float) -> float:
    """Phi(a), the standard normal CDF."""
    x = a * _SQRT1_2
    z = abs(x)
    if z < _SQRT1_2:
        return 0.5 + 0.5 * _erf(x)
    y = 0.5 * _erfc(z)
    return 1.0 - y if x > 0 else y


# Uniform-grid linear-interp LUT for Phi(z): the CDF table build is the
# host-side codec bottleneck and is pure erf volume. PL interp on a
# 1/1024-step grid has error ~3e-8 -- far below the 1/65536 CDF quantum --
# and a gather+FMA is several times cheaper than erf. Both coder sides
# use the same table, so streams stay self-consistent regardless.
_LUT_Z0, _LUT_Z1, _LUT_N = -8.5, 8.5, 17408
_LUT_INV_H = _LUT_N / (_LUT_Z1 - _LUT_Z0)
_LUT_TMAX = _LUT_N * (1 - 1e-12)
_LUT_TABLE = None


def _phi_table() -> np.ndarray:
    global _LUT_TABLE
    if _LUT_TABLE is None:
        z = np.linspace(_LUT_Z0, _LUT_Z1, _LUT_N + 1)
        _LUT_TABLE = np.array([ndtr(float(v)) for v in z], np.float64)
    return _LUT_TABLE


def _norm_cdf_fast(z: np.ndarray) -> np.ndarray:
    """Linear-interp Phi; operation-for-operation identical to the C++
    phi_lut (native/rans.cpp), so the two coders' streams match."""
    T = _phi_table()
    t = (z - _LUT_Z0) * _LUT_INV_H
    np.clip(t, 0.0, _LUT_TMAX, out=t)
    i = t.astype(np.int64)
    t -= i                                   # frac, in place
    lo = T[i]
    lo += (T[i + 1] - lo) * t
    return lo


def _gaussian_cdf_q_rows(mean, scale, q, min_v: int, max_v: int,
                         chunk: int = 32768) -> np.ndarray:
    """Quantized uint16 CDF rows of the Python coder, built in chunks and
    quantized in place (gaussian CDF rows are monotone by construction, so
    quantize_cdf's pre-sorting passes are unnecessary). Encode and decode
    both use this builder, so the rows are bit-identical across the round
    trip."""
    mean = np.asarray(mean, np.float64).ravel()
    scale = np.maximum(np.asarray(scale, np.float64).ravel(), 1e-9)
    qf = np.broadcast_to(np.asarray(q, np.float64).ravel(), mean.shape)
    kp1 = max_v - min_v + 2
    k = kp1 - 1
    samples = np.arange(min_v, max_v + 2, dtype=np.float64) - 0.5
    n = mean.shape[0]
    out = np.empty((n, kp1), np.uint16)
    ramp = np.arange(kp1, dtype=np.int32)
    for i in range(0, n, chunk):
        sl = slice(i, min(i + chunk, n))
        z = samples[None, :] * (qf[sl] / scale[sl])[:, None] \
            - (mean[sl] / scale[sl])[:, None]
        c = _norm_cdf_fast(z)
        qi = np.round(c * float(_PROB_SCALE - k)).astype(np.int32)
        qi += ramp
        qi[:, 0] = 0
        qi[:, -1] = _PROB_SCALE
        np.maximum.accumulate(qi, axis=1, out=qi)
        out[sl] = (qi & 0xFFFF).astype(np.uint16)
    return out


# thresholds on r = scale/Q for width-bucketing gaussian streams: the CDF
# table a row needs is ~ +-5*scale/Q symbols wide, so rows are grouped by
# r in powers of two and each group gets a snug shared table instead of
# the whole stream paying for its widest row
_BUCKET_EDGES = 2.0 ** np.arange(-1, 13)     # 0.5 .. 4096 -> 15 buckets
# a run of more symbols than there are probability slots (each takes at
# least one) cannot be coded: its residuals are stored raw, int32
# little-endian, and the decoder tells such a run by its header's range
_RAW_SYMBOLS = _PROB_SCALE


def _bucket_ids(scale: np.ndarray, q_arr: np.ndarray) -> np.ndarray:
    """Deterministic width-bucket assignment from (scale, Q) only -- both
    coder sides have these, so no per-row side info is transmitted."""
    return np.digitize(scale / q_arr, _BUCKET_EDGES)


def _gauss_args(mean_eff, scale, q_arr, min_v, max_v):
    T = _phi_table()
    return (_ptr(np.ascontiguousarray(mean_eff), ctypes.c_double),
            _ptr(np.ascontiguousarray(scale), ctypes.c_double),
            _ptr(np.ascontiguousarray(q_arr), ctypes.c_double),
            mean_eff.shape[0], min_v, max_v - min_v + 1,
            _ptr(T, ctypes.c_double), T.size, _LUT_Z0, _LUT_INV_H,
            _LUT_TMAX)


def _encode_gauss_run(sym0: np.ndarray, mean_eff: np.ndarray,
                      scale: np.ndarray, q_arr: np.ndarray,
                      min_v: int, max_v: int, native: bool) -> bytes:
    """One gaussian-coded run: the native coder computes 2 CDF edges a
    symbol on the fly, the Python coder builds the table rows; both give
    the same bytes (shared Phi LUT)."""
    if not native:
        cdf_q = _gaussian_cdf_q_rows(mean_eff, scale, q_arr, min_v, max_v)
        return _encode_q(sym0.astype(np.int32), cdf_q, native=False)
    n = sym0.shape[0]
    sym0 = np.ascontiguousarray(sym0, np.int32)
    out = np.empty(4 * n + 64, np.uint8)
    written = _native_lib().rans_encode_gaussian(
        _ptr(sym0, ctypes.c_int32),
        *_gauss_args(mean_eff, scale, q_arr, min_v, max_v),
        _ptr(out, ctypes.c_uint8), out.size)
    if written < 0:
        raise ValueError(f"rans_encode_gaussian failed: {written}")
    return out[:written].tobytes()


def _decode_gauss_run(data: bytes, mean_eff: np.ndarray, scale: np.ndarray,
                      q_arr: np.ndarray, min_v: int, max_v: int,
                      native: bool) -> np.ndarray:
    """Inverse of _encode_gauss_run; returns symbols in [0, K-1]."""
    if not native:
        cdf_q = _gaussian_cdf_q_rows(mean_eff, scale, q_arr, min_v, max_v)
        return _decode_q(data, cdf_q, native=False)
    buf = np.frombuffer(data, np.uint8)
    out = np.empty(mean_eff.shape[0], np.int32)
    rc = _native_lib().rans_decode_gaussian(
        _ptr(buf, ctypes.c_uint8), buf.size,
        *_gauss_args(mean_eff, scale, q_arr, min_v, max_v),
        _ptr(out, ctypes.c_int32))
    if rc != 0:
        raise ValueError(f"rans_decode_gaussian failed: {rc}")
    return out


def encode_gaussian(x, mean, scale, q, native: bool = True) -> bytes:
    """Quantize x to round(x/Q) and code with the gaussian model.

    Returns a self-contained bitstream blob. Mirrors encoder_gaussian
    (encodings.py:84-114) with two structural changes that keep the coded
    probabilities identical but collapse the CDF-table cost:

    - MEAN-CENTERING: sym = round(x/Q) - round(mean/Q), coded against a
      gaussian at mean - round(mean/Q)*Q, so the shared table spans the
      residual spread and not the global value span.
    - WIDTH BUCKETING: rows are grouped by scale/Q (power-of-two buckets,
      recomputed identically on decode) and each bucket's table spans only
      ITS residual range.

    Blob layout: u8 bucket count, then per bucket {i32 min, i32 max,
    u32 nbytes}, then the concatenated per-bucket rANS streams (a bucket
    whose range spans _RAW_SYMBOLS symbols or more, which no 16-bit
    table can hold, stores its residuals as raw int32 instead).
    """
    x = np.asarray(x, np.float64).ravel()
    q_arr = np.ascontiguousarray(
        np.broadcast_to(np.asarray(q, np.float64).ravel(), x.shape))
    mean = np.asarray(mean, np.float64).ravel()
    scale = np.maximum(np.asarray(scale, np.float64).ravel(), 1e-9)
    center = np.round(mean / q_arr)          # decode recomputes this
    mean_eff = mean - center * q_arr
    sym_val = (np.round(x / q_arr) - center).astype(np.int64)

    bid = _bucket_ids(scale, q_arr)
    nb = len(_BUCKET_EDGES) + 1
    header = [struct.pack('<B', nb)]
    streams = []
    for b in range(nb):
        sel = np.nonzero(bid == b)[0]
        if sel.size == 0:
            header.append(struct.pack('<iiI', 0, -1, 0))
            continue
        s = sym_val[sel]
        min_v, max_v = int(s.min()), int(s.max())
        if max_v - min_v + 1 >= _RAW_SYMBOLS:
            data = (s - min_v).astype('<i4').tobytes()
        else:
            data = _encode_gauss_run((s - min_v).astype(np.int32),
                                     mean_eff[sel], scale[sel], q_arr[sel],
                                     min_v, max_v, native)
        header.append(struct.pack('<iiI', min_v, max_v, len(data)))
        streams.append(data)
    return b''.join(header) + b''.join(streams)


def decode_gaussian(data: bytes, mean, scale, q,
                    native: bool = True) -> np.ndarray:
    """Inverse of encode_gaussian -> dequantized float64 values.

    The bucket assignment and the centering round(mean/Q) are recomputed
    from (mean, scale, Q) -- identical float64 math to the encode side --
    so the output (residual + center) * Q matches round(x/Q) * Q exactly.
    """
    mean = np.asarray(mean, np.float64).ravel()
    q_arr = np.ascontiguousarray(
        np.broadcast_to(np.asarray(q, np.float64).ravel(), mean.shape))
    scale = np.maximum(np.asarray(scale, np.float64).ravel(), 1e-9)
    center = np.round(mean / q_arr)
    mean_eff = mean - center * q_arr
    bid = _bucket_ids(scale, q_arr)

    nb = struct.unpack_from('<B', data, 0)[0]
    metas = [struct.unpack_from('<iiI', data, 1 + 12 * b)
             for b in range(nb)]
    pos = 1 + 12 * nb
    out = np.empty(mean.shape[0], np.float64)
    for b, (min_v, max_v, nbytes) in enumerate(metas):
        sel = np.nonzero(bid == b)[0]
        if sel.size == 0:
            pos += nbytes
            continue
        if max_v - min_v + 1 >= _RAW_SYMBOLS:
            sym = np.frombuffer(data, '<i4', sel.size, pos).astype(
                np.int64) + min_v
        else:
            sym = _decode_gauss_run(data[pos:pos + nbytes], mean_eff[sel],
                                    scale[sel], q_arr[sel], min_v, max_v,
                                    native).astype(np.int64) + min_v
        out[sel] = (sym.astype(np.float64) + center[sel]) * q_arr[sel]
        pos += nbytes
    return out


def _binary_cdf(p_one, n: int) -> np.ndarray:
    p = np.broadcast_to(np.asarray(p_one, np.float64), (n,)).ravel()
    return np.stack([np.zeros_like(p), 1.0 - p, np.ones_like(p)], -1)


def encode_binary(x, p_one, native: bool = True) -> bytes:
    """Bernoulli-code a {-1,+1} (or {0,1}) array given P(one).

    Mirrors the reference's encoder (encodings.py:141-157): symbol =
    floor((x+1)/2) with cdf rows [0, 1-p, 1]."""
    x = np.asarray(x).ravel()
    sym = (x > 0).astype(np.int32)
    return encode_with_cdf(sym, _binary_cdf(p_one, x.size), native)


def decode_binary(data, p_one, n: int, as_pm1: bool = True,
                  native: bool = True) -> np.ndarray:
    sym = decode_with_cdf(data, _binary_cdf(p_one, n), native)
    return (sym * 2 - 1).astype(np.float32) if as_pm1 \
        else sym.astype(np.float32)
