"""PNG codec for the images the supported datasets ship (stdlib + numpy).

EuRoC, TUM-VI and KITTI store 8-bit gray frames, TUM RGB-D 8-bit RGB(A)
colour frames and 16-bit gray depth maps (big-endian samples).  The
reference package decodes them with imageio or Pillow; neither is part of
the environment this port targets, so the port decodes them itself, the
same way on every machine:

- the chunks are read, the IDAT payloads joined and inflated with ``zlib``;
- each scanline's filter (None, Sub, Up, Average, Paeth) is reversed, in
  vector operations: Average and Paeth, serial along a row, are reversed
  one anti-diagonal of the image at a time;
- the samples become a uint8 (H, W[, C]) array, or uint16 (H, W) for 16-bit
  gray, as Pillow returns them.

Interlaced, palette and other sample layouts raise ``ValueError`` naming
the file.  ``encode_png`` / ``write_png`` write the same layouts with filter
0 on every row.
"""

import functools
import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels: gray, RGB, gray + alpha, RGBA (3 = palette: not
# supported).
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
_COLOUR_TYPE = {v: k for k, v in _CHANNELS.items()}


@functools.lru_cache(maxsize=None)
def _predictors():
    """The five filters' predictors less c, as one flat int32 table indexed
    by ``f * 511**2 + (a - c + 255) * 511 + (b - c + 255)`` (a: the byte bpp
    to the left, b: above, c: above-left).  Each is a function of a - c and
    b - c alone: Sub a - c, Up b - c, Average ((a - c) + (b - c)) >> 1 and
    Paeth one of a - c, b - c, 0; None is 0 and ``_wavefront`` adds no c
    to it."""
    d = np.arange(-255, 256)
    da, db = d[:, None], d[None, :]
    pa, pb, pc = np.abs(db), np.abs(da), np.abs(da + db)
    paeth = np.where((pa <= pb) & (pa <= pc), da, np.where(pb <= pc, db, 0))
    zero = np.zeros_like(paeth)
    return np.stack([zero, da + zero, db + zero, (da + db) >> 1,
                     paeth]).astype(np.int32).reshape(-1)


def _wavefront(ftypes, data, prior, bpp):
    """Reverse the filters of rows of any type, including Average and Paeth,
    whose bytes depend on the reconstructed byte bpp to their left.  Pixel
    (y, j) depends only on (y, j - 1), (y - 1, j) and (y - 1, j - 1), so the
    pixels of one anti-diagonal y + j = k are independent: the rows are
    skewed so that step k reconstructs diagonal k in one vector operation,
    h + w - 1 steps in all instead of a loop over every byte."""
    h, stride = data.shape
    w = stride // bpp                           # pixels per row
    table = _predictors()
    filt = data.astype(np.int32).reshape(h, w, bpp)
    n_diag = h + w - 1
    skewed = np.zeros((n_diag, h, bpp), np.int32)       # [k, y] = (y, k - y)
    for y in range(h):
        skewed[y:y + w, y] = filt[y]
    # rec[k + 2, y + 1] is the reconstructed pixel (y, k - y); row y = -1
    # holds the prior row and everything off the image stays 0.
    rec = np.zeros((n_diag + 2, h + 1, bpp), np.int32)
    rec[1:w + 1, 0] = prior.reshape(w, bpp)
    f = ftypes.astype(np.int32)[:, None]
    offset = f * 511 * 511 + 255 * 511 + 255
    plus_c = (f != 0).astype(np.int32)
    for k in range(n_diag):
        y0, y1 = max(0, k - w + 1), min(h, k + 1)
        a = rec[k + 1, y0 + 1:y1 + 1]
        b = rec[k + 1, y0:y1]
        c = rec[k, y0:y1]
        idx = a * 511
        idx += b
        idx -= c * 512
        idx += offset[y0:y1]
        v = table.take(idx)
        v += c * plus_c[y0:y1]
        v += skewed[k, y0:y1]
        v &= 0xFF
        rec[k + 2, y0 + 1:y1 + 1] = v
    out = np.empty((h, stride), np.uint8)
    for y in range(h):
        out[y] = rec[y + 2:y + 2 + w, y + 1].reshape(-1)
    return out


def _unfilter(raw, height, stride, bpp, name):
    """Reverse the per-scanline filters of the inflated image data: row by
    row up to the first Average or Paeth row, then ``_wavefront``."""
    if len(raw) < height * (stride + 1):
        raise ValueError(f"{name}: truncated PNG image data")
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(
        height, stride + 1)
    ftypes, data = rows[:, 0], rows[:, 1:]
    if int(ftypes.max(initial=0)) > 4:
        raise ValueError(f"{name}: unknown PNG filter type "
                         f"{int(ftypes.max())}")
    serial = np.flatnonzero(ftypes >= 3)
    first = int(serial[0]) if serial.size else height
    out = np.empty((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(first):
        f, line = int(ftypes[y]), data[y]
        if f == 0:
            rec = line
        elif f == 1:
            # Sub: a running sum (mod 256) of every bpp-th byte.
            pad = (-stride) % bpp
            rec = np.cumsum(np.concatenate([line, np.zeros(pad, np.uint8)])
                            .reshape(-1, bpp), axis=0, dtype=np.uint8
                            ).reshape(-1)[:stride]
        else:
            rec = line + prior
        out[y] = rec
        prior = out[y]
    if first < height:
        out[first:] = _wavefront(ftypes[first:], data[first:], prior, bpp)
    return out


def decode_png(data, name="<bytes>"):
    """PNG bytes -> numpy array: uint8 (H, W) gray, (H, W, 2) gray + alpha,
    (H, W, 3) RGB, (H, W, 4) RGBA, or uint16 (H, W) for 16-bit gray."""
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{name}: not a PNG file")
    pos, header, idat = 8, None, []
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{name}: PNG without IHDR or IDAT")
    width, height, depth, colour, _, _, interlace = header
    if interlace:
        raise ValueError(f"{name}: interlaced PNG is not supported")
    if colour not in _CHANNELS:
        raise ValueError(f"{name}: PNG colour type {colour} (palette) is not "
                         "supported")
    ch = _CHANNELS[colour]
    if not (depth == 8 or (depth == 16 and colour == 0)):
        raise ValueError(f"{name}: PNG bit depth {depth} with colour type "
                         f"{colour} is not supported")
    bpp = ch * depth // 8
    raw = zlib.decompress(b"".join(idat))
    pix = _unfilter(raw, height, width * bpp, bpp, name)
    if depth == 16:
        return pix.view(">u2").reshape(height, width).astype(np.uint16)
    return pix.reshape(height, width, ch) if ch > 1 else pix.reshape(height,
                                                                     width)


def read_png(path):
    with open(path, "rb") as f:
        return decode_png(f.read(), name=str(path))


def _chunk(ctype, body):
    return (struct.pack(">I", len(body)) + ctype + body
            + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))


def encode_png(img):
    """uint8 (H, W[, C]) with C in 2, 3, 4, or uint16 (H, W) -> PNG bytes,
    filter 0 on every row."""
    img = np.asarray(img)
    ch = 1 if img.ndim == 2 else img.shape[2]
    if img.dtype == np.uint16 and ch == 1:
        depth, rows = 16, img.astype(">u2").view(np.uint8)
    elif img.dtype == np.uint8 and ch in _COLOUR_TYPE:
        depth, rows = 8, img
    else:
        raise ValueError(f"encode_png: unsupported array {img.dtype} "
                         f"{img.shape}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(rows).reshape(h, -1)
    raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, _COLOUR_TYPE[ch], 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path, img):
    with open(path, "wb") as f:
        f.write(encode_png(img))
    return path
