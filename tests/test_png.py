"""The stdlib PNG codec (tpurt/utils/png.py) that replaced Pillow on the
main path: glTF texture decode and the offline CLI's PNG write."""
import struct
import zlib

import numpy as np
import pytest

from tpurt.utils.png import decode_png, encode_png


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _png(rows_raw, w, h, color_type, extra=b""):
    """Assemble a PNG from already-filtered scanlines."""
    header = struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header) + extra
            + _chunk(b"IDAT", zlib.compress(rows_raw)) + _chunk(b"IEND", b""))


def _filter(img, ftype):
    """Encode-side PNG filters (RFC 2083 §6), one type for every row."""
    h, w, c = img.shape
    a = img.reshape(h, w * c).astype(np.int32)
    out = []
    prev = np.zeros(w * c, np.int32)
    for y in range(h):
        row = a[y]
        left = np.concatenate([np.zeros(c, np.int32), row[:-c]])
        up_left = np.concatenate([np.zeros(c, np.int32), prev[:-c]])
        if ftype == 0:
            pred = np.zeros_like(row)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) >> 1
        else:
            p = left + prev - up_left
            pa, pb, pc = (np.abs(p - left), np.abs(p - prev),
                          np.abs(p - up_left))
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, up_left))
        out.append(bytes([ftype]) + ((row - pred) & 0xFF).astype(
            np.uint8).tobytes())
        prev = row
    return b"".join(out)


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_round_trip(channels):
    rng = np.random.default_rng(channels)
    img = rng.integers(0, 256, (17, 23, channels), dtype=np.uint8)
    np.testing.assert_array_equal(decode_png(encode_png(img)), img)


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("channels,color_type", [(3, 2), (4, 6), (1, 0)])
def test_decode_every_filter(ftype, channels, color_type):
    rng = np.random.default_rng(ftype)
    img = rng.integers(0, 256, (9, 13, channels), dtype=np.uint8)
    img[:, :6] = np.arange(6, dtype=np.uint8)[None, :, None] * 40
    data = _png(_filter(img, ftype), 13, 9, color_type)
    np.testing.assert_array_equal(decode_png(data), img)


def test_gray_alpha_expands_to_rgba():
    ga = np.stack([np.arange(12, dtype=np.uint8).reshape(3, 4) * 20,
                   np.full((3, 4), 200, np.uint8)], axis=-1)
    out = decode_png(_png(_filter(ga, 4), 4, 3, 4))
    assert out.shape == (3, 4, 4)
    np.testing.assert_array_equal(out[..., :3],
                                  np.repeat(ga[..., :1], 3, axis=-1))
    np.testing.assert_array_equal(out[..., 3], ga[..., 1])


def test_palette_with_and_without_transparency():
    palette = np.array([[255, 0, 0], [0, 255, 0], [0, 0, 255]], np.uint8)
    idx = np.array([[0, 1, 2], [2, 1, 0]], np.uint8)[..., None]
    plte = _chunk(b"PLTE", palette.tobytes())
    rgb = decode_png(_png(_filter(idx, 1), 3, 2, 3, plte))
    np.testing.assert_array_equal(rgb, palette[idx[..., 0]])
    trns = _chunk(b"tRNS", bytes([10, 20]))
    rgba = decode_png(_png(_filter(idx, 0), 3, 2, 3, plte + trns))
    np.testing.assert_array_equal(rgba[..., 3],
                                  np.array([10, 20, 255], np.uint8)[idx[..., 0]])


def test_rejects_what_it_does_not_cover():
    header = struct.pack(">IIBBBBB", 2, 2, 16, 2, 0, 0, 0)
    data = (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", header)
            + _chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="bit depth 16"):
        decode_png(data)
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"\xff\xd8\xff\xe0 jpeg")


def test_offline_cli_png_reads_back(tmp_path):
    from tpurt.app.offline import write_png

    img = np.random.default_rng(3).integers(0, 256, (8, 5, 3), np.uint8)
    path = tmp_path / "f.png"
    write_png(str(path), img)
    np.testing.assert_array_equal(decode_png(path.read_bytes()), img)
