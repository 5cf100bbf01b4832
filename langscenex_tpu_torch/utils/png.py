"""PNG files and PIL's bicubic resize, in numpy.

The JAX package reads and writes images through PIL; the machine the
port runs on has no Pillow, so this module stands in for it with
``zlib``, ``struct`` and numpy:

- :func:`read_png` decodes 8-bit gray, gray + alpha, RGB, RGBA and
  palette PNGs, and 1-, 2- and 4-bit gray and palette ones (filters 0-4).
  Interlaced and 16-bit files, and any file that is not a PNG (a JPEG,
  for one), raise ``ValueError``.
  Rows filtered with Average or Paeth decode at Python speed (each byte
  depends on the one before it); None, Sub and Up rows are vectorised.
- :func:`write_png` writes gray, gray + alpha, RGB, RGBA or palette
  images, every row with filter 0.
- :func:`png_size` reads (width, height) from the IHDR chunk.
- :func:`to_rgb` is PIL's ``convert("RGB")`` on a decoded array.
- :func:`resize_bicubic` is PIL's default ``Image.resize`` on an 8-bit
  image: separable bicubic (a = -0.5) with the support widened on
  downscaling, 22-bit fixed-point weights, the horizontal pass first and
  an 8-bit intermediate, as Pillow's Resample.c computes it; the identity
  at the same size.
"""
from __future__ import annotations

import struct
import zlib
from typing import Optional, Tuple

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> channels (0 gray, 2 RGB, 3 palette, 4 gray + alpha, 6 RGBA)
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunks(data: bytes, path: str):
    if data[:8] != SIGNATURE:
        kind = ("a JPEG" if data[:3] == b"\xff\xd8\xff" else
                "not a PNG")
        raise ValueError(f"{path}: {kind} file; only PNG images are read")
    pos = 8
    while pos + 8 <= len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        yield tag, data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IEND":
            return
    raise ValueError(f"{path}: truncated PNG (no IEND chunk)")


def _header(body: bytes, path: str) -> Tuple[int, int, int, int, int]:
    w, h, depth, ctype, _, _, interlace = struct.unpack(">IIBBBBB", body)
    if interlace:
        raise ValueError(f"{path}: interlaced PNGs are not read")
    if ctype not in _CHANNELS:
        raise ValueError(f"{path}: unknown PNG colour type {ctype}")
    if depth != 8 and not (depth in (1, 2, 4) and ctype in (0, 3)):
        raise ValueError(f"{path}: {depth}-bit PNGs of colour type {ctype} "
                         "are not read (8-bit, or 1/2/4-bit gray and "
                         "palette only)")
    return w, h, depth, ctype, _CHANNELS[ctype]


def png_size(path: str) -> Tuple[int, int]:
    """(width, height) of a PNG file, from its IHDR chunk."""
    with open(path, "rb") as f:
        head = f.read(33)
    tag, body = next(_chunks(head + b"\0" * 12, path))
    if tag != b"IHDR":
        raise ValueError(f"{path}: PNG without a leading IHDR chunk")
    w, h = struct.unpack(">II", body[:8])
    return w, h


def _paeth_row(f: bytearray, prior: bytes, bpp: int) -> bytearray:
    out = bytearray(len(f))
    for i in range(len(f)):
        a = out[i - bpp] if i >= bpp else 0
        b = prior[i]
        c = prior[i - bpp] if i >= bpp else 0
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        pred = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
        out[i] = (f[i] + pred) & 0xFF
    return out


def _average_row(f: bytearray, prior: bytes, bpp: int) -> bytearray:
    out = bytearray(len(f))
    for i in range(len(f)):
        a = out[i - bpp] if i >= bpp else 0
        out[i] = (f[i] + ((a + prior[i]) >> 1)) & 0xFF
    return out


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    if len(raw) < h * (stride + 1):
        raise ValueError("PNG image data is shorter than its header says")
    rows = np.frombuffer(raw, np.uint8, h * (stride + 1)).reshape(
        h, stride + 1)
    kinds = rows[:, 0]
    if kinds.max(initial=0) > 4:
        raise ValueError(f"unknown PNG filter type {int(kinds.max())}")
    out = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        f, k = rows[y, 1:], kinds[y]
        if k == 0:
            out[y] = f
        elif k == 1:        # Sub: a running sum along the row, per channel
            out[y] = np.cumsum(f.reshape(-1, bpp), 0,
                               dtype=np.uint8).reshape(-1)
        elif k == 2:        # Up
            out[y] = f + prior
        elif k == 3:        # Average
            out[y] = np.frombuffer(_average_row(bytearray(f), prior.tobytes(),
                                                bpp), np.uint8)
        else:               # Paeth
            out[y] = np.frombuffer(_paeth_row(bytearray(f), prior.tobytes(),
                                              bpp), np.uint8)
        prior = out[y]
    return out


def read_png(path: str) -> np.ndarray:
    """An 8-bit PNG as uint8: [H,W] gray, [H,W,2] gray + alpha, [H,W,3]
    RGB, [H,W,4] RGBA. A palette image is expanded through its palette
    to [H,W,3] RGB, or [H,W,4] RGBA when it has a tRNS chunk."""
    with open(path, "rb") as f:
        data = f.read()
    hdr = None
    palette = trns = None
    idat = []
    for tag, body in _chunks(data, path):
        if tag == b"IHDR":
            hdr = _header(body, path)
        elif tag == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(body, np.uint8)
        elif tag == b"IDAT":
            idat.append(body)
    if hdr is None:
        raise ValueError(f"{path}: PNG without an IHDR chunk")
    w, h, depth, ctype, ch = hdr
    stride = (w * ch * depth + 7) // 8
    px = _unfilter(zlib.decompress(b"".join(idat)), h, stride,
                   max(ch * depth // 8, 1))
    if depth < 8:               # samples packed from the high bits down
        shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
        px = ((px[..., None] >> shifts) & ((1 << depth) - 1)).reshape(
            h, -1)[:, :w]
        if ctype == 0:          # gray scaled to 8 bits
            px = px * np.uint8(255 // ((1 << depth) - 1))
    px = px.reshape(h, w, ch)
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without a PLTE chunk")
        idx = px[..., 0]
        if trns is None:
            return palette[idx]
        alpha = np.full(len(palette), 255, np.uint8)
        alpha[:len(trns)] = trns[:len(palette)]
        return np.concatenate([palette[idx], alpha[idx][..., None]], -1)
    return px[..., 0] if ch == 1 else px


def to_rgb(img: np.ndarray) -> np.ndarray:
    """PIL's ``convert("RGB")`` of a decoded image: gray is repeated into
    three channels, alpha is dropped."""
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] in (1, 2):
        return np.repeat(img[..., :1], 3, -1)
    return np.ascontiguousarray(img[..., :3])


def _chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray,
              palette: Optional[np.ndarray] = None) -> None:
    """Write uint8 [H,W] (gray, or palette indices with ``palette``
    [N,3]), [H,W,1], [H,W,2], [H,W,3] or [H,W,4] as an 8-bit PNG."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png takes uint8 pixels, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    h, w, ch = img.shape
    if palette is not None:
        if ch != 1:
            raise ValueError("a palette image takes [H,W] indices")
        ctype = 3
    else:
        ctype = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
    rows = np.zeros((h, w * ch + 1), np.uint8)        # filter 0 per row
    rows[:, 1:] = img.reshape(h, w * ch)
    parts = [SIGNATURE, _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8,
                                                    ctype, 0, 0, 0))]
    if palette is not None:
        parts.append(_chunk(b"PLTE", np.asarray(palette, np.uint8)
                            .reshape(-1, 3).tobytes()))
    parts += [_chunk(b"IDAT", zlib.compress(rows.tobytes())),
              _chunk(b"IEND", b"")]
    with open(path, "wb") as f:
        f.write(b"".join(parts))


# Pillow's Resample.c: 8-bit results from 22-bit fixed-point weights
_PRECISION_BITS = 32 - 8 - 2


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _coeffs(in_size: int, out_size: int):
    """precompute_coeffs + normalize_coeffs_8bpc: per output sample its
    first input index and fixed-point weights [out, ksize]."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(np.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size)
    xmax = xmax - xmin
    x = np.arange(ksize)
    w = _bicubic((x[None] + xmin[:, None] - center[:, None] + 0.5)
                 * (1.0 / filterscale))
    w = np.where(x[None] < xmax[:, None], w, 0.0)
    ww = w.sum(1, keepdims=True)
    w = np.where(ww != 0.0, w / np.where(ww != 0.0, ww, 1.0), w)
    k = np.trunc(np.where(w < 0, -0.5, 0.5) + w * (1 << _PRECISION_BITS))
    return xmin, k.astype(np.int64)


def _resample(img: np.ndarray, axis: int, out_size: int) -> np.ndarray:
    """One pass along ``axis`` (0 rows, 1 columns) of a uint8 [H,W,C]."""
    in_size = img.shape[axis]
    xmin, k = _coeffs(in_size, out_size)
    idx = np.minimum(xmin[:, None] + np.arange(k.shape[1])[None],
                     in_size - 1)                    # [out, ksize]
    src = np.take(img.astype(np.int64), idx, axis=axis)
    if axis == 0:               # src [out, ksize, W, C]
        acc = np.einsum("okwc,ok->owc", src, k)
    else:                       # src [H, out, ksize, C]
        acc = np.einsum("hokc,ok->hoc", src, k)
    acc = acc + (1 << (_PRECISION_BITS - 1))
    return np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)


def resize_bicubic(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """PIL's ``Image.resize((W, H))`` (bicubic) of a uint8 [H,W] or
    [H,W,C] image; the same array at the same size."""
    W, H = size
    img = np.asarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"resize_bicubic takes uint8 pixels, got "
                         f"{img.dtype}")
    if img.shape[:2] == (H, W):
        return img
    x = img[..., None] if img.ndim == 2 else img
    if x.shape[1] != W:
        x = _resample(x, 1, W)
    if x.shape[0] != H:
        x = _resample(x, 0, H)
    return x[..., 0] if img.ndim == 2 else x
