"""PNG codec and resampling helpers (texturefusion_tpu/io/image.py):
round trips in the TUM formats, decoding of every PNG filter type and of
OpenCV-written files, and agreement with OpenCV's resize and blur."""

import struct
import zlib

import numpy as np
import pytest

from texturefusion_tpu.io import image


def _rgb8(h=23, w=31, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3)
                                                ).astype(np.uint8)


def _gray16(h=19, w=27, seed=1):
    return np.random.default_rng(seed).integers(0, 65536, (h, w)
                                                ).astype(np.uint16)


@pytest.mark.parametrize("make", [_rgb8, _gray16], ids=["rgb8", "gray16"])
def test_png_round_trip(tmp_path, make):
    img = make()
    path = str(tmp_path / "x.png")
    image.write_png(path, img)
    back = image.read_png(path)
    assert back.dtype == img.dtype and back.shape == img.shape
    np.testing.assert_array_equal(back, img)


def _filter_rows(rows: np.ndarray, bpp: int, ftypes) -> bytes:
    """Reference PNG encoder filter step, one byte at a time (PNG spec
    §9.2), cycling through the given filter types row by row."""
    out = []
    rows = rows.astype(int)
    for y, row in enumerate(rows):
        ft = ftypes[y % len(ftypes)]
        prev = rows[y - 1] if y else np.zeros_like(row)
        out.append(ft)
        for x in range(len(row)):
            a = row[x - bpp] if x >= bpp else 0
            b = prev[x]
            c = prev[x - bpp] if x >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            paeth = a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)
            pred = (0, a, b, (a + b) // 2, paeth)[ft]
            out.append((row[x] - pred) & 0xFF)
    return bytes(out)


@pytest.mark.parametrize("decoder", ["native", "numpy"])
@pytest.mark.parametrize("make,color_type,depth,bpp",
                         [(_rgb8, 2, 8, 3), (_gray16, 0, 16, 2)],
                         ids=["rgb8", "gray16"])
def test_png_decodes_every_filter_type(tmp_path, monkeypatch, make,
                                       color_type, depth, bpp, decoder):
    if decoder == "numpy":     # the fallback for hosts without g++
        monkeypatch.setattr(image.native, "get_lib", lambda: None)
    else:
        assert image.native.get_lib() is not None
    img = make()
    h, w = img.shape[:2]
    rows = img.astype(img.dtype.newbyteorder(">")).view(np.uint8
                                                        ).reshape(h, -1)
    data = _filter_rows(rows, bpp, [0, 1, 2, 3, 4, 4, 3])

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload
                + struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))

    path = tmp_path / "f.png"
    path.write_bytes(
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color_type,
                                     0, 0, 0))
        + chunk(b"IDAT", zlib.compress(data)) + chunk(b"IEND", b""))
    np.testing.assert_array_equal(image.read_png(str(path)), img)


def _smooth_rgb8(h=64, w=96):
    yy, xx = np.mgrid[0:h, 0:w]
    noise = np.random.default_rng(2).integers(0, 8, (h, w))
    return np.stack([xx * 2 + noise, yy * 3, (xx + yy + noise) % 256],
                    -1).astype(np.uint8)


def test_png_writer_mixes_filter_types(tmp_path):
    """Rows get libpng's adaptive choice, so files the program writes
    (the TUM proxy among them) exercise the decoder like real ones."""
    img = _smooth_rgb8()
    path = str(tmp_path / "m.png")
    image.write_png(path, img)
    buf = open(path, "rb").read()
    (n,) = struct.unpack(">I", buf[33:37])
    assert buf[37:41] == b"IDAT"
    data = np.frombuffer(zlib.decompress(buf[41:41 + n]), np.uint8)
    ftypes = set(data.reshape(img.shape[0], -1)[:, 0].tolist())
    assert len(ftypes) > 1 and ftypes <= {0, 1, 2, 3, 4}
    np.testing.assert_array_equal(image.read_png(path), img)


def test_png_decodes_opencv_files(tmp_path):
    cv2 = pytest.importorskip("cv2")
    rgb, d16 = _rgb8(48, 64), _gray16(48, 64)
    cv2.imwrite(str(tmp_path / "c.png"), cv2.cvtColor(rgb, cv2.COLOR_RGB2BGR))
    cv2.imwrite(str(tmp_path / "d.png"), d16)
    np.testing.assert_array_equal(image.read_png(str(tmp_path / "c.png")), rgb)
    np.testing.assert_array_equal(image.read_png(str(tmp_path / "d.png")), d16)
    # and OpenCV reads ours
    image.write_png(str(tmp_path / "o.png"), rgb)
    back = cv2.imread(str(tmp_path / "o.png"), cv2.IMREAD_UNCHANGED)
    np.testing.assert_array_equal(back[..., ::-1], rgb)


@pytest.mark.parametrize("out_w,out_h", [(24, 24), (80, 96), (7, 100)])
def test_resize_matches_opencv_inter_linear(out_w, out_h):
    cv2 = pytest.importorskip("cv2")
    img = _rgb8(37, 53, seed=4)
    ref = cv2.resize(img, (out_w, out_h), interpolation=cv2.INTER_LINEAR)
    got = image.resize_bilinear(img, out_w, out_h)
    assert got.shape == ref.shape and got.dtype == np.uint8
    # OpenCV interpolates uint8 in 11-bit fixed point: one level of slack
    assert np.abs(got.astype(int) - ref).max() <= 1


def test_blur_matches_opencv_gaussian():
    cv2 = pytest.importorskip("cv2")
    img = np.random.default_rng(5).random((60, 80, 3)).astype(np.float32)
    ref = cv2.GaussianBlur(img, (0, 0), 3.0)
    np.testing.assert_allclose(image.gaussian_blur(img, 3.0), ref, atol=1e-5)
