"""The stdlib PNG reader/writer (io/png.py) that replaced PIL on the
training path: committed dataset images, every scanline filter, the three
supported color types, and loud failure on anything else."""

import glob
import os
import struct
import zlib

import numpy as np
import pytest

from edgegaussians_tpu.io import png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COMMITTED = sorted(glob.glob(os.path.join(
    REPO, "synthetic_data", "**", "*.png"), recursive=True))


def _raw_png(width, height, depth, ctype, interlace=0, raw=b""):
    def chunk(t, body):
        return (struct.pack(">I", len(body)) + t + body
                + struct.pack(">I", zlib.crc32(t + body) & 0xFFFFFFFF))
    ihdr = struct.pack(">IIBBBBB", width, height, depth, ctype, 0, 0,
                       interlace)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
            + chunk(b"IDAT", zlib.compress(raw)) + chunk(b"IEND", b""))


def test_committed_pngs_decode_like_pil():
    Image = pytest.importorskip("PIL.Image")
    assert COMMITTED, "synthetic_data/ PNGs are committed"
    for path in COMMITTED[:3]:
        ours = png.read_png(path)
        with Image.open(path) as im:
            np.testing.assert_array_equal(ours, np.asarray(im))
            np.testing.assert_array_equal(png.to_gray(ours),
                                          np.asarray(im.convert("L")))


def test_committed_pngs_use_nontrivial_filters():
    # the committed scans exercise the Sub/Up/Paeth predictors, so the
    # decoder's filter code is covered by real data, not only by our writer
    with open(COMMITTED[0], "rb") as f:
        data = f.read()
    img = png.read_png(COMMITTED[0])
    raw = zlib.decompress(b"".join(
        body for t, body in png._chunks(data) if t == b"IDAT"))
    stride = img.shape[1] * (1 if img.ndim == 2 else img.shape[2]) + 1
    assert len({raw[i * stride] for i in range(img.shape[0])}) > 1


@pytest.mark.parametrize("shape", [(7, 5), (6, 4, 3), (3, 9, 4)],
                         ids=["gray", "rgb", "rgba"])
def test_write_read_roundtrip(tmp_path, shape):
    x = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    png.write_png(tmp_path / "x.png", x)
    np.testing.assert_array_equal(png.read_png(tmp_path / "x.png"), x)


@pytest.mark.parametrize("shape", [(9, 11), (8, 6, 3), (5, 7, 4)],
                         ids=["gray", "rgb", "rgba"])
def test_reads_every_filter_type(tmp_path, shape):
    """PIL's optimizing encoder picks per-line filters (Sub, Up, Average,
    Paeth); the decoder must undo each exactly."""
    Image = pytest.importorskip("PIL.Image")
    x = np.random.default_rng(1).integers(0, 256, shape, dtype=np.uint8)
    x = np.cumsum(x, axis=1, dtype=np.uint8)       # smooth rows: mixed filters
    Image.fromarray(x).save(tmp_path / "x.png", optimize=True)
    np.testing.assert_array_equal(png.read_png(tmp_path / "x.png"), x)


def test_to_gray_matches_pil_luminance():
    Image = pytest.importorskip("PIL.Image")
    x = np.random.default_rng(2).integers(0, 256, (16, 16, 4),
                                          dtype=np.uint8)
    want = np.asarray(Image.fromarray(x[..., :3]).convert("L"))
    np.testing.assert_array_equal(png.to_gray(x), want)


@pytest.mark.parametrize("depth,ctype,interlace", [
    (16, 0, 0),      # 16-bit gray
    (8, 3, 0),       # palette
    (8, 4, 0),       # gray + alpha
    (8, 0, 1),       # Adam7 interlace
], ids=["16bit", "palette", "gray_alpha", "interlaced"])
def test_unsupported_formats_fail_loudly(tmp_path, depth, ctype, interlace):
    path = tmp_path / "bad.png"
    path.write_bytes(_raw_png(2, 2, depth, ctype, interlace, b"\0" * 8))
    with pytest.raises(ValueError, match="unsupported PNG"):
        png.read_png(path)


def test_rejects_corrupt_files(tmp_path):
    path = tmp_path / "x.png"
    png.write_png(path, np.zeros((4, 4), np.uint8))
    data = bytearray(path.read_bytes())
    data[-20] ^= 0xFF                                # flip a byte of IDAT
    path.write_bytes(bytes(data))
    with pytest.raises(ValueError):
        png.read_png(path)
    (tmp_path / "y.png").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not a PNG"):
        png.read_png(tmp_path / "y.png")


def test_load_image_uses_png_reader(tmp_path):
    from edgegaussians_tpu.data.parsers import load_image_grayscale
    x = np.random.default_rng(3).integers(0, 256, (6, 5, 3), dtype=np.uint8)
    png.write_png(tmp_path / "a.png", x)
    got = load_image_grayscale(str(tmp_path), "a.jpg")  # .jpg -> .png
    np.testing.assert_array_equal(got, png.to_gray(x).astype(np.float32))
