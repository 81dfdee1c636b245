import numpy as np
import pytest

from mitsubaer_tpu.utils import io


class TestEXR:
    def test_roundtrip_rgb(self, tmp_path):
        rng = np.random.default_rng(0)
        img = rng.uniform(0, 10, (37, 53, 3)).astype(np.float32)
        p = tmp_path / "t.exr"
        io.write_exr(p, img)
        img2, names = io.read_exr(p)
        assert names == ["R", "G", "B"]
        np.testing.assert_array_equal(img2, img)

    def test_roundtrip_single_channel(self, tmp_path):
        img = np.arange(64, dtype=np.float32).reshape(8, 8)
        p = tmp_path / "t.exr"
        io.write_exr(p, img)
        img2, names = io.read_exr(p)
        np.testing.assert_array_equal(img2[..., 0], img)

    def test_multichannel_names(self, tmp_path):
        img = np.ones((4, 4, 2), np.float32)
        io.write_exr(tmp_path / "t.exr", img, channel_names=["dist", "alpha"])
        img2, names = io.read_exr(tmp_path / "t.exr")
        assert sorted(names) == ["alpha", "dist"]


class TestVol:
    def test_roundtrip(self, tmp_path):
        rng = np.random.default_rng(1)
        data = rng.uniform(0, 1, (5, 6, 7)).astype(np.float32)
        p = tmp_path / "t.vol"
        io.write_vol(p, data, (-1, -2, -3), (1, 2, 3))
        d2, lo, hi = io.read_vol(p)
        np.testing.assert_array_equal(d2[..., 0], data)
        np.testing.assert_array_equal(lo, [-1, -2, -3])
        np.testing.assert_array_equal(hi, [1, 2, 3])

    def test_reads_reference_format_header(self, tmp_path):
        # byte-level check against the documented layout (gridvolume.cpp:54-97)
        io.write_vol(tmp_path / "t.vol", np.zeros((2, 3, 4), np.float32), (0, 0, 0), (1, 1, 1))
        raw = open(tmp_path / "t.vol", "rb").read()
        assert raw[:4] == b"VOL\x03"
        import struct

        enc, nx, ny, nz, ch = struct.unpack_from("<iiiii", raw, 4)
        assert (enc, nx, ny, nz, ch) == (1, 4, 3, 2, 1)


class TestObj:
    def test_load_quad(self, tmp_path):
        p = tmp_path / "q.obj"
        p.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nf 1 2 3 4\n")
        v, f = io.load_obj(p)
        assert v.shape == (4, 3)
        assert f.shape == (2, 3)  # fan triangulation

    def test_load_reference_cbox(self):
        import os

        path = "/root/reference/scenes/cbox/meshes/cbox_floor.obj"
        if not os.path.exists(path):
            pytest.skip("reference scenes not mounted")
        v, f = io.load_obj(path)
        assert v.shape[0] == 12 and f.shape[0] == 2

    def test_ply_ascii(self, tmp_path):
        p = tmp_path / "t.ply"
        p.write_text(
            "ply\nformat ascii 1.0\nelement vertex 3\n"
            "property float x\nproperty float y\nproperty float z\n"
            "element face 1\nproperty list uchar int vertex_indices\n"
            "end_header\n0 0 0\n1 0 0\n0 1 0\n3 0 1 2\n"
        )
        v, f = io.load_ply(p)
        assert v.shape == (3, 3) and f.shape == (1, 3)


def test_pfm_roundtrip(tmp_path):
    from mitsubaer_tpu.utils import io as mio

    img = np.random.default_rng(3).uniform(0, 40, (7, 5, 3)).astype(np.float32)
    p = tmp_path / "x.pfm"
    mio.write_pfm(p, img)
    back = mio.read_pfm(p)
    np.testing.assert_array_equal(back, img)
    np.testing.assert_array_equal(mio.read_image(p), img)


def test_pfm_single_channel(tmp_path):
    from mitsubaer_tpu.utils import io as mio

    img = np.random.default_rng(4).uniform(0, 2, (4, 6)).astype(np.float32)
    p = tmp_path / "g.pfm"
    mio.write_pfm(p, img)
    back = mio.read_pfm(p)
    np.testing.assert_array_equal(back[..., 0], img)


def test_rgbe_roundtrip(tmp_path):
    from mitsubaer_tpu.utils import io as mio

    rng = np.random.default_rng(5)
    # wide dynamic range incl. zeros
    img = (rng.uniform(0, 1, (9, 11, 3)) ** 4 * 1e3).astype(np.float32)
    img[0, 0] = 0.0
    p = tmp_path / "x.hdr"
    mio.write_rgbe(p, img)
    back = mio.read_rgbe(p)
    # shared-exponent quantization: the step is ~1/256 of the per-pixel MAX
    # channel, so small channels carry absolute error proportional to it
    step = np.max(img, axis=-1, keepdims=True) / 256.0
    assert np.all(np.abs(back - img) <= 0.02 * img + 1.5 * step + 1e-6)
    assert np.all(back[0, 0] == 0.0)


def test_rgbe_rle_decode(tmp_path):
    """Adaptive-RLE scanlines (the common Radiance encoding) decode: build
    a synthetic RLE file for a constant row + a varying row."""
    from mitsubaer_tpu.utils import io as mio

    w = 12
    row_const = np.tile(np.array([64, 128, 32, 130], np.uint8), (w, 1))
    rng = np.random.default_rng(6)
    row_var = rng.integers(1, 255, (w, 4)).astype(np.uint8)
    row_var[:, 3] = 129
    with open(tmp_path / "r.hdr", "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y 2 +X {w}\n".encode())
        # row 0: RLE, each plane one run packet
        f.write(bytes([2, 2, 0, w]))
        for c in range(4):
            f.write(bytes([128 + w, int(row_const[0, c])]))
        # row 1: RLE, each plane one dump packet
        f.write(bytes([2, 2, 0, w]))
        for c in range(4):
            f.write(bytes([w]) + row_var[:, c].tobytes())
    img = mio.read_rgbe(tmp_path / "r.hdr")
    assert img.shape == (2, w, 3)
    expect0 = (row_const[:, :3].astype(np.float32) + 0.5) * 2.0 ** (130 - 136)
    np.testing.assert_allclose(img[0], expect0)
    expect1 = (row_var[:, :3].astype(np.float32) + 0.5) * 2.0 ** (129 - 136)
    np.testing.assert_allclose(img[1], expect1)


def test_png_roundtrip_header_and_crc(tmp_path):
    """write_png emits a valid PNG: signature, IHDR fields, a CRC-32 over
    every chunk, and pixels that read back exactly (gamma off)."""
    import struct
    import zlib

    from mitsubaer_tpu.utils import io as mio

    rng = np.random.default_rng(3)
    img = rng.integers(0, 256, (5, 7, 3)).astype(np.float32) / 255.0
    path = tmp_path / "a.png"
    mio.write_png(path, img, gamma=False)
    data = path.read_bytes()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, types, idat = 8, [], b""
    while pos < len(data):
        (ln,) = struct.unpack(">I", data[pos:pos + 4])
        typ, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + ln]
        (crc,) = struct.unpack(">I", data[pos + 8 + ln:pos + 12 + ln])
        assert crc == zlib.crc32(typ + body) & 0xFFFFFFFF, typ
        if typ == b"IHDR":
            assert struct.unpack(">IIBBBBB", body) == (7, 5, 8, 2, 0, 0, 0)
        if typ == b"IDAT":
            idat += body
        types.append(typ)
        pos += 12 + ln
    assert types[0] == b"IHDR" and types[-1] == b"IEND" and b"IDAT" in types
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(5, 1 + 21)
    assert (rows[:, 0] == 0).all()                  # filter type None
    np.testing.assert_array_equal(rows[:, 1:].reshape(5, 7, 3),
                                  np.round(img * 255).astype(np.uint8))
    assert mio.read_image(path).shape == (5, 7, 3)
