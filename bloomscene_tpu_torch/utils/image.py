"""PNG files and image resizing without PIL.

The JAX pipeline reads its input with PIL (``Image.open(...).resize``),
resizes with PIL and writes its eval renders with imageio. The port does
all three here, on the standard library's ``zlib`` and numpy, so that
one path runs wherever the port runs:

- ``read_png``: 8-bit gray, RGB and RGBA PNGs, not interlaced, with any of
  the five row filters; any other kind of PNG raises ``ValueError``.
- ``write_png``: the same three kinds, every row with filter 0 (None).
- ``resize``: PIL's ``Image.resize`` with its default filter (bicubic,
  a = -0.5), uint8 in and out, computed as PIL's ``libImaging/Resample.c``
  does: a horizontal pass then a vertical one, each with the filter's
  support widened by the scale when it shrinks, coefficients normalized
  to sum 1 and rounded to 22-bit fixed point, every pass rounding to
  uint8. An unchanged size returns a copy, as PIL's does.
"""
from __future__ import annotations

import math
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG color type -> channels (0 gray, 2 RGB, 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 6: 4}
_COLOR_TYPE = {1: 0, 3: 2, 4: 6}


def _chunks(data: bytes):
    pos = len(_SIGNATURE)
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        kind = data[pos + 4:pos + 8]
        yield kind, data[pos + 8:pos + 8 + n]
        pos += 12 + n


def _paeth_row(line: bytearray, prev: bytes, bpp: int) -> None:
    """Undo the Paeth filter of one row in place."""
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prev[i]
        c = prev[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        if pa <= pb and pa <= pc:
            pred = a
        elif pb <= pc:
            pred = b
        else:
            pred = c
        line[i] = (line[i] + pred) & 0xFF


def _unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        start = y * (stride + 1)
        kind = raw[start]
        line = np.frombuffer(raw, np.uint8, stride, start + 1)
        if kind == 0:
            row = line.copy()
        elif kind == 1:      # Sub: running sums of each channel, mod 256
            row = (np.cumsum(line.reshape(-1, bpp), 0, dtype=np.int64)
                   & 0xFF).astype(np.uint8).reshape(-1)
        elif kind == 2:      # Up
            row = line + prev
        elif kind == 3:      # Average
            buf = bytearray(line.tobytes())
            p = prev.tobytes()
            for i in range(stride):
                a = buf[i - bpp] if i >= bpp else 0
                buf[i] = (buf[i] + ((a + p[i]) >> 1)) & 0xFF
            row = np.frombuffer(bytes(buf), np.uint8)
        elif kind == 4:      # Paeth
            buf = bytearray(line.tobytes())
            _paeth_row(buf, prev.tobytes(), bpp)
            row = np.frombuffer(bytes(buf), np.uint8)
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        out[y] = row
        prev = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """PNG file -> uint8 [H, W] (gray), [H, W, 3] (RGB) or [H, W, 4]
    (RGBA)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, color, _, _, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: unsupported PNG (bit depth {depth}, color type "
            f"{color}, interlace {interlace}); only 8-bit gray, RGB and "
            "RGBA without interlacing are read")
    ch = _CHANNELS[color]
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != height * (width * ch + 1):
        raise ValueError(f"{path}: image data has {len(raw)} bytes, "
                         f"expected {height * (width * ch + 1)}")
    pixels = _unfilter(raw, height, width * ch, ch)
    return pixels.reshape(height, width, ch) if ch > 1 else \
        pixels.reshape(height, width)


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, image: np.ndarray) -> None:
    """uint8 [H, W], [H, W, 1], [H, W, 3] or [H, W, 4] -> PNG file."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    if img.ndim != 3 or img.shape[-1] not in _COLOR_TYPE:
        raise ValueError(f"write_png: shape {image.shape} is not [H, W] or "
                         "[H, W, 1|3|4]")
    h, w, ch = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8),
                           np.ascontiguousarray(img).reshape(h, w * ch)], 1)
    header = struct.pack(">IIBBBBB", w, h, 8, _COLOR_TYPE[ch], 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_SIGNATURE + _chunk(b"IHDR", header)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))


# ---------------- resize (PIL's bicubic) ----------------

_PRECISION_BITS = 32 - 8 - 2
_BICUBIC_SUPPORT = 2.0


def _bicubic(x: float) -> float:
    a = -0.5
    x = abs(x)
    if x < 1.0:
        return ((a + 2.0) * x - (a + 3.0)) * x * x + 1
    if x < 2.0:
        return (((x - 5) * x + 8) * x - 4) * a
    return 0.0


def _coefficients(in_size: int, out_size: int):
    """Per output position: the first input index, the tap count and the
    fixed-point taps (``precompute_coeffs`` and
    ``normalize_coeffs_8bpc``)."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = _BICUBIC_SUPPORT * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    first = np.zeros(out_size, np.int64)
    taps = np.zeros((out_size, ksize), np.int64)
    ss = 1.0 / filterscale
    for xx in range(out_size):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        w = [_bicubic((x + xmin - center + 0.5) * ss) for x in range(xmax)]
        ww = sum(w)   # summed in order, as the C loop does
        if ww != 0.0:
            w = [v / ww for v in w]
        one = 1 << _PRECISION_BITS
        taps[xx, :xmax] = [int(-0.5 + v * one) if v < 0
                           else int(0.5 + v * one) for v in w]
        first[xx] = xmin
    return first, taps


def _resample(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    """One pass along ``axis`` of a uint8 [H, W, C] image."""
    in_size = img.shape[axis]
    first, taps = _coefficients(in_size, out_size)
    ksize = taps.shape[1]
    # taps past an output position's count are 0, so a clamped index reads
    # some pixel that contributes nothing
    idx = np.minimum(first[:, None] + np.arange(ksize)[None], in_size - 1)
    src = np.moveaxis(img, axis, 0).astype(np.int64)     # [in, other, C]
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1),
                  np.int64)
    for k in range(ksize):
        acc += src[idx[:, k]] * taps[:, k][:, None, None]
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.moveaxis(out, 0, axis)


def resize(image: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """uint8 [H, W] or [H, W, C] -> the image at ``size = (H', W')``, as
    PIL's ``Image.fromarray(image).resize((W', H'))`` gives it (bicubic).
    The same size returns a copy."""
    img = np.asarray(image)
    if img.dtype != np.uint8:
        raise ValueError(f"resize takes uint8, got {img.dtype}")
    out_h, out_w = (int(s) for s in size)
    if out_h < 1 or out_w < 1:
        raise ValueError(f"resize: size {size} must be positive")
    gray = img.ndim == 2
    work = img[..., None] if gray else img
    h, w = work.shape[:2]
    if out_w != w:
        # PIL resamples only the input rows the vertical pass reads; the
        # rows it skips do not change the rows it keeps
        work = _resample(work, out_w, 1)
    if out_h != h:
        work = _resample(work, out_h, 0)
    work = np.array(work, copy=True)
    return work[..., 0] if gray else work
