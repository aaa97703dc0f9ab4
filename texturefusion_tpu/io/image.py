"""Image file and resampling helpers on numpy, zlib and scipy alone.

The pipeline reads and writes exactly the TUM RGB-D formats — 8-bit RGB
colour PNGs and 16-bit grayscale depth PNGs (ref: DatasetWrapper.hpp
image loading) — and resizes atlas patches with bilinear interpolation
(ref: Atlas.cpp:71-91 UpdateBuffer, cv::resize INTER_LINEAR). These
helpers implement those operations directly so that no image library is
needed at run time. PNG scanline unfiltering runs in the native library
(native/png_unfilter.cpp), with a slower numpy twin for hosts without a
C++ toolchain.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import scipy.ndimage

from texturefusion_tpu import native

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# colour type -> channels, for the types this codec handles
_CHANNELS = {0: 1, 2: 3}


def _chunk(tag: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(tag + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", crc)


def _paeth(a, b, c):
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """PNG-filter [H, S] scanline bytes into [H, 1 + S], each row with
    the type (0-4) whose output has the least sum of |byte| read as
    signed — libpng's adaptive heuristic, so the files carry the same
    mix of filters as libpng-written ones."""
    h, s = rows.shape
    padded = np.concatenate([np.zeros((1, s), np.uint8), rows])
    out = np.empty((h, 1 + s), np.uint8)
    for y0 in range(0, h, 256):          # bounded temporaries for atlases
        x = padded[y0 + 1:y0 + 257].astype(np.int16)
        b = padded[y0:y0 + len(x)].astype(np.int16)
        a, c = np.zeros_like(x), np.zeros_like(b)
        a[:, bpp:], c[:, bpp:] = x[:, :-bpp], b[:, :-bpp]
        cand = (np.stack([x, x - a, x - b, x - ((a + b) >> 1),
                          x - _paeth(a, b, c)]) & 0xFF).astype(np.uint8)
        cost = np.abs(cand.view(np.int8).astype(np.int32)).sum(-1)
        best = np.argmin(cost, axis=0)
        out[y0:y0 + len(x), 0] = best
        out[y0:y0 + len(x), 1:] = cand[best, np.arange(len(x))]
    return out


def write_png(path: str, img: np.ndarray) -> None:
    """Write an [H, W, 3] uint8 RGB image or an [H, W] uint8/uint16
    grayscale image as PNG."""
    img = np.asarray(img)
    if img.ndim == 3 and img.shape[2] == 3 and img.dtype == np.uint8:
        color_type, depth = 2, 8
    elif img.ndim == 2 and img.dtype in (np.uint8, np.uint16):
        color_type, depth = 0, img.dtype.itemsize * 8
    else:
        raise ValueError(f"unsupported PNG image {img.shape} {img.dtype}")
    h, w = img.shape[:2]
    rows = np.ascontiguousarray(img.astype(img.dtype.newbyteorder(">"))
                                ).view(np.uint8).reshape(h, -1)
    raw = _filter(rows, 3 if color_type == 2 else depth // 8)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, color_type, 0, 0, 0)
    with open(path, "wb") as f:
        # zlib level 1: large atlases are written fast
        f.write(_PNG_SIG + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 1))
                + _chunk(b"IEND", b""))


def _unfilter_py(data: np.ndarray, h: int, stride: int,
                 bpp: int) -> np.ndarray:
    """numpy twin of native/png_unfilter.cpp. Average and Paeth chain
    every byte to its left neighbour, so it decodes anti-diagonals of
    (row, pixel), which depend only on the two before them."""
    npx = stride // bpp
    ys, xs = np.indices((h, npx))
    diag = np.zeros((h + npx - 1, h, bpp), np.int16)
    diag[ys + xs, ys] = data[:, 1:].reshape(h, npx, bpp)
    # t[d + 2, y + 1] is pixel (y, d - y); zero borders above and left
    t = np.zeros((h + npx + 1, h + 1, bpp), np.int16)
    ft = data[:, :1]
    for d in range(h + npx - 1):
        lo, hi = max(0, d - npx + 1), min(h, d + 1)
        a, b, c = t[d + 1, lo + 1:hi + 1], t[d + 1, lo:hi], t[d, lo:hi]
        f = ft[lo:hi]
        pred = np.where(f == 1, a, np.where(f == 2, b, np.where(
            f == 3, (a + b) >> 1, np.where(f == 4, _paeth(a, b, c), 0))))
        t[d + 2, lo + 1:hi + 1] = (diag[d, lo:hi] + pred) & 0xFF
    return t[ys + xs + 2, ys + 1].reshape(h, stride).astype(np.uint8)


def _unfilter(data: np.ndarray, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row PNG filters (types 0-4, PNG spec §9) of
    [H, 1 + stride] filtered scanlines; returns [H, stride] bytes."""
    if np.any(data[:, 0] > 4):
        raise ValueError("corrupt PNG: unknown filter type")
    lib = native.get_lib()
    if lib is None:
        return _unfilter_py(data, h, stride, bpp)
    data = np.ascontiguousarray(data)
    out = np.empty((h, stride), np.uint8)
    lib.png_unfilter(data.ctypes.data, h, stride, bpp, out.ctypes.data)
    return out


def read_png(path: str) -> np.ndarray:
    """Read a non-interlaced 8- or 16-bit grayscale or RGB PNG.
    Returns [H, W] for grayscale, else [H, W, 3]; uint8 or uint16."""
    with open(path, "rb") as f:
        buf = f.read()
    if buf[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(buf):
        (n,) = struct.unpack(">I", buf[pos:pos + 4])
        tag, data = buf[pos + 4:pos + 8], buf[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif tag == b"IDAT":
            idat.append(data)
        elif tag == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: missing IHDR")
    w, h, depth, color_type, _, _, interlace = hdr
    if color_type not in _CHANNELS or depth not in (8, 16) or interlace:
        raise ValueError(f"{path}: unsupported PNG (colour type "
                         f"{color_type}, bit depth {depth}, interlace "
                         f"{interlace})")
    ch = _CHANNELS[color_type]
    bpp = ch * depth // 8
    data = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = _unfilter(data.reshape(h, 1 + w * bpp), h, w * bpp, bpp)
    if depth == 16:
        img = rows.view(">u2").astype(np.uint16)
    else:
        img = rows
    img = img.reshape(h, w, ch)
    return img[..., 0] if ch == 1 else img


def resize_bilinear(img: np.ndarray, out_w: int, out_h: int) -> np.ndarray:
    """Bilinear resize of [H, W(, C)] with the half-pixel-centre
    convention of cv::resize INTER_LINEAR (edge samples clamped).
    uint8 input is rounded back to uint8."""
    h, w = img.shape[:2]

    def taps(n_out, n_in):
        s = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        s = np.clip(s, 0.0, n_in - 1)
        i0 = np.floor(s).astype(np.int64)
        i1 = np.minimum(i0 + 1, n_in - 1)
        return i0, i1, (s - i0).astype(np.float32)

    y0, y1, fy = taps(out_h, h)
    x0, x1, fx = taps(out_w, w)
    src = img.astype(np.float32)
    trail = (1,) * (src.ndim - 2)          # broadcast over channels
    fy = fy.reshape((-1, 1) + trail)
    fx = fx.reshape((-1,) + trail)
    rows = src[y0] * (1 - fy) + src[y1] * fy
    out = rows[:, x0] * (1 - fx) + rows[:, x1] * fx
    if img.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out.astype(img.dtype)


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """Spatial Gaussian blur of [H, W(, C)] float images, matching
    cv::GaussianBlur(img, (0, 0), sigma) on float input: a kernel of
    radius round(4·sigma) with mirrored (BORDER_REFLECT_101) borders."""
    sig = (sigma, sigma) + (0.0,) * (img.ndim - 2)
    return scipy.ndimage.gaussian_filter(img, sig, mode="mirror",
                                         truncate=4.0)
