"""The port's numpy image operations (``ivit_tpu_torch/train/image_ops.py``)
bit for bit against Pillow, on seeded images.

Each op runs on images of 1 to 300 pixels a side (a share of them 1 to 3
pixels wide, where the border and tie cases live) of four kinds: noise,
smooth gradients with noise, flat colours and saturated 0/255 pixels.
Tolerance 0 everywhere.  The decoders read files that Pillow writes (PNG
of every colour type at the bit depths it chooses, 24-bit BMP) and
hand-made PNGs with each of the five filter types and the 1/2/4-bit
gray and palette depths; the cases the port does not reproduce raise.
"""

import io
import struct
import zlib

import numpy as np
import pytest
import torch
from PIL import Image, ImageEnhance, ImageFilter, ImageOps

from ivit_tpu_torch.train import image_ops as ops


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread, as every port CPU test file (Tier-1 runs six
    workers at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _image(rng, h, w, kind):
    if kind == 0:
        return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
    if kind == 1:
        yy, xx = np.mgrid[0:h, 0:w]
        base = (np.sin(xx / 7.0)[..., None] * 100 + np.cos(yy / 5.0)[..., None] * 80
                + 128 + rng.normal(0, 10, (h, w, 3)))
        return np.clip(base, 0, 255).astype(np.uint8)
    if kind == 2:
        return np.full((h, w, 3), rng.integers(0, 256, 3), np.uint8)
    return rng.choice(np.array([0, 255], np.uint8), (h, w, 3))


def _images(seed, n):
    """``n`` seeded images: every fourth 1-3 pixels a side, the rest 1-300."""
    rng = np.random.default_rng(seed)
    for i in range(n):
        hi = 4 if i % 4 == 3 else 301
        h, w = (int(v) for v in rng.integers(1, hi, 2))
        yield rng, _image(rng, h, w, i % 4)


def _pil(img):
    return Image.fromarray(img)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_resize_matches_pillow(seed):
    """Up and down, one axis unchanged, both unchanged, to 1 pixel."""
    for i, (rng, img) in enumerate(_images(seed, 40)):
        h, w = img.shape[:2]
        th, tw = (int(v) for v in rng.integers(1, 301, 2))
        targets = [(th, tw), (h, tw), (th, w), (h, w), (1, 1), (224, 224)]
        for size in targets[:3] if i % 3 else targets:
            want = np.asarray(_pil(img).resize((size[1], size[0]), Image.BICUBIC))
            np.testing.assert_array_equal(ops.resize_bicubic(img, size), want,
                                          err_msg=f"{img.shape} -> {size}")


@pytest.mark.parametrize("resample", [ops.BILINEAR, ops.BICUBIC])
def test_affine_matches_pillow(resample):
    """RandAugment's shears and translations, and a rotation-and-scale
    matrix, with a fill colour."""
    for rng, img in _images(3 + resample, 40):
        h, w = img.shape[:2]
        fill = tuple(int(v) for v in rng.integers(0, 256, 3))
        v = float(rng.uniform(-0.3, 0.3))
        a = float(rng.uniform(-1, 1))
        for m in [(1, v, 0, 0, 1, 0), (1, 0, 0, v, 1, 0),
                  (1, 0, v * w * 1.5, 0, 1, 0), (1, 0, 0, 0, 1, v * h * 1.5),
                  (1.3 * np.cos(a), np.sin(a), 2.5, -np.sin(a), 0.7 * np.cos(a), -1.5)]:
            want = np.asarray(_pil(img).transform(_pil(img).size, Image.AFFINE, m,
                                                  resample=resample, fillcolor=fill))
            np.testing.assert_array_equal(ops.affine(img, m, fill, resample), want,
                                          err_msg=f"{img.shape} {m}")


@pytest.mark.parametrize("resample", [ops.BILINEAR, ops.BICUBIC])
def test_rotate_matches_pillow(resample):
    """Random angles, and Pillow's shortcuts (0, -0, 90, 180, 270, 360,
    -90), on square and oblong images."""
    special = [0.0, -0.0, 90.0, 180.0, 270.0, 360.0, -90.0]
    for i, (rng, img) in enumerate(_images(5 + resample, 40)):
        if i % 2:
            s = img.shape[0]
            img = _image(rng, s, s, i % 4)
        fill = tuple(int(v) for v in rng.integers(0, 256, 3))
        for deg in (float(rng.uniform(-30, 30)), special[i % len(special)]):
            want = np.asarray(_pil(img).rotate(deg, resample=resample, fillcolor=fill))
            np.testing.assert_array_equal(ops.rotate(img, deg, fill, resample), want,
                                          err_msg=f"{img.shape} {deg}")


_POINT_OPS = {
    "autocontrast": (lambda img, rng: ops.autocontrast(img),
                     lambda pil, rng: ImageOps.autocontrast(pil)),
    "equalize": (lambda img, rng: ops.equalize(img),
                 lambda pil, rng: ImageOps.equalize(pil)),
    "invert": (lambda img, rng: ops.invert(img), lambda pil, rng: ImageOps.invert(pil)),
    "posterize": (lambda img, rng: ops.posterize(img, rng.bits),
                  lambda pil, rng: ImageOps.posterize(pil, rng.bits)),
    "solarize": (lambda img, rng: ops.solarize(img, rng.threshold),
                 lambda pil, rng: ImageOps.solarize(pil, rng.threshold)),
}


class _Args:
    pass


@pytest.mark.parametrize("name", sorted(_POINT_OPS))
def test_point_ops_match_pillow(name):
    port, pil_op = _POINT_OPS[name]
    for i, (rng, img) in enumerate(_images(7, 40)):
        args = _Args()
        args.bits = 1 + i % 8
        args.threshold = int(rng.integers(0, 257))
        want = np.asarray(pil_op(_pil(img), args))
        np.testing.assert_array_equal(port(img, args), want, err_msg=str(img.shape))


def test_gray_blend_and_smooth_match_pillow():
    for rng, img in _images(8, 40):
        np.testing.assert_array_equal(ops.to_gray(img), np.asarray(_pil(img).convert("L")))
        np.testing.assert_array_equal(ops.smooth(img),
                                      np.asarray(_pil(img).filter(ImageFilter.SMOOTH)))
        other = _image(rng, *img.shape[:2], kind=0)
        for alpha in (float(rng.uniform(-1, 0)), 0.0, float(rng.uniform(0, 1)), 1.0,
                      float(rng.uniform(1, 3))):
            np.testing.assert_array_equal(
                ops.blend(img, other, alpha),
                np.asarray(Image.blend(_pil(img), _pil(other), alpha)))


_ENHANCE = {"color": (ops.enhance_color, ImageEnhance.Color),
            "contrast": (ops.enhance_contrast, ImageEnhance.Contrast),
            "brightness": (ops.enhance_brightness, ImageEnhance.Brightness),
            "sharpness": (ops.enhance_sharpness, ImageEnhance.Sharpness)}


@pytest.mark.parametrize("name", sorted(_ENHANCE))
def test_enhance_matches_pillow(name):
    """Every factor class: below 0, 0, (0, 1), 1, above 1 (RandAugment's
    increasing levels reach 0.1-1.9)."""
    port, pil_cls = _ENHANCE[name]
    for rng, img in _images(9, 40):
        for f in (float(rng.uniform(-0.5, 0)), 0.0, float(rng.uniform(0, 1)), 1.0,
                  float(rng.uniform(1, 2.5))):
            want = np.asarray(pil_cls(_pil(img)).enhance(f))
            np.testing.assert_array_equal(port(img, f), want,
                                          err_msg=f"{img.shape} factor {f}")


# ---------------------------------------------------------------------------
# decoders
# ---------------------------------------------------------------------------

def _chunk(kind, body):
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _png(rows, width, depth, color, kinds, palette=None, interlace=0):
    """A PNG of the packed scanlines ``rows`` ([H, stride] uint8), each row
    filtered with its ``kinds`` entry (PNG spec section 9)."""
    bpp = max(1, {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color] * depth // 8)
    rows = rows.astype(np.int32)
    prior = np.zeros_like(rows[0])
    raw = b""
    for r, k in zip(rows, kinds):
        left = np.concatenate([np.zeros(bpp, np.int32), r[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prior[:-bpp]])
        pred = [0, left, prior, (left + prior) >> 1, _paeth(left, prior, upleft)][k]
        raw += bytes([k]) + ((r - pred) & 0xFF).astype(np.uint8).tobytes()
        prior = r
    body = (b"\x89PNG\r\n\x1a\n"
            + _chunk(b"IHDR", struct.pack(">IIBBBBB", width, len(rows), depth, color,
                                          0, 0, interlace)))
    if palette is not None:
        body += _chunk(b"PLTE", palette.tobytes())
    return body + _chunk(b"IDAT", zlib.compress(raw)) + _chunk(b"IEND", b"")


def _pillow_rgb(data):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


@pytest.mark.parametrize("mode", ["L", "RGB", "P", "LA", "RGBA", "1"])
def test_png_written_by_pillow_decodes_as_pillow(tmp_path, mode):
    """Colour types 0, 2, 3, 4, 6 as Pillow writes them (adaptive filters,
    palettes of 2 to 200 colours at the depth Pillow picks)."""
    rng = np.random.default_rng(10)
    for i in range(8):
        h, w = (int(v) for v in rng.integers(1, 70, 2))
        rgb = _image(rng, h, w, i % 4)
        if mode == "P":
            im = _pil(rgb).convert("P", palette=Image.ADAPTIVE,
                                   colors=[2, 3, 4, 9, 16, 17, 200, 256][i])
        elif mode == "RGBA":
            im = Image.fromarray(np.dstack([rgb, rgb[..., :1]]))
        else:
            im = _pil(rgb).convert(mode)
        path = tmp_path / f"{i}.png"
        im.save(path, optimize=bool(i % 2))
        data = path.read_bytes()
        np.testing.assert_array_equal(ops.decode_png(data, str(path)), _pillow_rgb(data))


@pytest.mark.parametrize("color,depth", [(0, 8), (2, 8), (4, 8), (6, 8), (3, 8),
                                         (0, 1), (0, 2), (0, 4), (3, 1), (3, 2), (3, 4)])
def test_png_every_filter_type_decodes_as_pillow(color, depth):
    """Hand-made PNGs whose rows take each of the five filter types, at the
    bit depths the decoder reproduces."""
    rng = np.random.default_rng(11 + color * 16 + depth)
    for width in (1, 3, 7, 33):
        height = 10
        channels = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[color]
        samples = rng.integers(0, 1 << depth, (height, width * channels)).astype(np.uint8)
        bits = np.unpackbits(samples[..., None], axis=2)[..., 8 - depth:]
        rows = np.packbits(bits.reshape(height, -1), axis=1)
        palette = (rng.integers(0, 256, ((1 << depth), 3), dtype=np.uint8)
                   if color == 3 else None)
        data = _png(rows, width, depth, color, [k % 5 for k in range(height)], palette)
        np.testing.assert_array_equal(ops.decode_png(data), _pillow_rgb(data),
                                      err_msg=f"width {width}")


@pytest.mark.parametrize("mode,transparency", [("P", 3), ("L", 7), ("RGB", (1, 2, 3))])
def test_png_with_transparency_decodes_as_pillow(mode, transparency):
    """A tRNS chunk changes no pixel of ``convert("RGB")``."""
    rng = np.random.default_rng(13)
    im = _pil(_image(rng, 9, 13, 0))
    im = (im.convert("P", palette=Image.ADAPTIVE, colors=16) if mode == "P"
          else im.convert(mode))
    buf = io.BytesIO()
    im.save(buf, format="PNG", transparency=transparency)
    data = buf.getvalue()
    assert b"tRNS" in data
    np.testing.assert_array_equal(ops.decode_png(data), _pillow_rgb(data))


def test_bmp_decodes_as_pillow(tmp_path):
    """24-bit BMPs as Pillow writes them (bottom-up, rows padded to 4
    bytes) and a top-down one (negative height)."""
    rng = np.random.default_rng(12)
    for i in range(8):
        h, w = (int(v) for v in rng.integers(1, 70, 2))
        path = tmp_path / f"{i}.bmp"
        _pil(_image(rng, h, w, i % 4)).save(path)
        data = path.read_bytes()
        np.testing.assert_array_equal(ops.decode_bmp(data, str(path)), _pillow_rgb(data))
    img = _image(rng, 5, 7, 0)
    stride = (7 * 3 + 3) // 4 * 4
    pix = np.zeros((5, stride), np.uint8)
    pix[:, :21] = img[..., ::-1].reshape(5, 21)
    header = struct.pack("<IiiHHIIiiII", 40, 7, -5, 1, 24, 0, pix.size, 2835, 2835, 0, 0)
    data = b"BM" + struct.pack("<IHHI", 54 + pix.size, 0, 0, 54) + header + pix.tobytes()
    np.testing.assert_array_equal(ops.decode_bmp(data), _pillow_rgb(data))
    np.testing.assert_array_equal(ops.decode_bmp(data), img)


def test_decoders_raise_on_what_they_do_not_reproduce(tmp_path):
    rows = np.zeros((2, 12), np.uint8)
    with pytest.raises(ValueError, match="16-bit PNG"):
        ops.decode_png(_png(rows, 2, 16, 2, [0, 0]))
    with pytest.raises(ValueError, match="interlaced"):
        ops.decode_png(_png(np.zeros((2, 6), np.uint8), 2, 8, 2, [0, 0], interlace=1))
    with pytest.raises(ValueError, match="palette index"):
        ops.decode_png(_png(np.full((2, 2), 5, np.uint8), 2, 8, 3, [0, 0],
                            np.zeros((2, 3), np.uint8)))
    for mode, bits in (("RGBA", "32-bit"), ("P", "8-bit")):
        path = tmp_path / f"{mode}.bmp"
        Image.new(mode, (3, 2)).save(path)
        with pytest.raises(ValueError, match=bits):
            ops.decode_bmp(path.read_bytes(), str(path))
    with pytest.raises(ValueError, match="not a PNG"):
        ops.decode_png(b"BM" + bytes(60))
