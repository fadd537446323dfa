"""The image operations of the training pipeline, in numpy, bit for bit as
Pillow computes them on RGB uint8 HWC arrays.

The JAX package's transforms and RandAugment call Pillow (``Image.resize``,
``Image.transform``, ``Image.rotate``, ``ImageOps``, ``ImageEnhance``,
``ImageFilter.SMOOTH``) and decode files through ``Image.open``.  This
module computes the same bytes without Pillow: each function reproduces the
arithmetic of Pillow's C code (``Resample.c``, ``Geometry.c``, ``Blend.c``,
``Filter.c``, ``Convert.c``) or of the lookup tables ``ImageOps`` builds in
Python, and ``tests/test_torch_port_image_ops.py`` holds each against
Pillow on seeded images.  Where an input falls outside what is reproduced
(an interlaced or 16-bit PNG, a BMP that is not 24-bit), the function
raises and names the case; it never returns an approximation.

Every float operation here is an elementwise numpy operation in the
precision and order Pillow's C code uses (no reductions, no matmuls), so
the result does not depend on the machine.
"""

from __future__ import annotations

import math
import struct
import zlib

import numpy as np

BILINEAR, BICUBIC = 2, 3              # Pillow's Resampling values
_PRECISION_BITS = 32 - 8 - 2          # Resample.c's fixed point


def _rgb(img: np.ndarray) -> np.ndarray:
    if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
        raise ValueError(f"expected an RGB uint8 HWC array, got {img.dtype}{list(img.shape)}")
    return img


# ---------------------------------------------------------------------------
# resize (Resample.c, bicubic)
# ---------------------------------------------------------------------------

def _bicubic_filter(x: np.ndarray) -> np.ndarray:
    """Catmull-Rom, a = -0.5, as Resample.c's ``bicubic_filter`` in f64."""
    x = np.abs(x)
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = (((x - 5.0) * x + 8.0) * x - 4.0) * -0.5
    return np.where(x < 1.0, near, np.where(x < 2.0, far, 0.0))


def _resample_coeffs(in_size: int, out_size: int):
    """``precompute_coeffs`` + ``normalize_coeffs_8bpc``: each output's first
    source index and its taps as int32 fixed point (22 fractional bits,
    rounded away from zero), zero past the output's support."""
    scale = in_size / out_size
    filterscale = max(scale, 1.0)
    support = 2.0 * filterscale
    ksize = int(math.ceil(support)) * 2 + 1
    center = (np.arange(out_size) + 0.5) * scale
    xmin = np.maximum((center - support + 0.5).astype(np.int64), 0)
    xmax = np.minimum((center + support + 0.5).astype(np.int64), in_size) - xmin
    ss = 1.0 / filterscale
    taps = np.arange(ksize)
    w = _bicubic_filter(((taps[None, :] + xmin[:, None]) - center[:, None] + 0.5) * ss)
    w = np.where(taps[None, :] < xmax[:, None], w, 0.0)
    ww = np.zeros(out_size)
    for t in range(ksize):                     # the C loop's order of the sum
        ww = ww + w[:, t]
    w = np.where(ww[:, None] != 0.0, w / np.where(ww == 0.0, 1.0, ww)[:, None], w)
    scaled = w * float(1 << _PRECISION_BITS)
    k = np.where(w < 0, -0.5 + scaled, 0.5 + scaled).astype(np.int32)  # trunc
    return xmin, k


def _resample_axis(img: np.ndarray, out_size: int, axis: int) -> np.ndarray:
    in_size = img.shape[axis]
    xmin, k = _resample_coeffs(in_size, out_size)
    src = np.moveaxis(img, axis, 0).astype(np.int32)
    acc = np.full((out_size,) + src.shape[1:], 1 << (_PRECISION_BITS - 1), np.int32)
    for t in range(k.shape[1]):
        idx = np.minimum(xmin + t, in_size - 1)   # taps past the support are 0
        kt = k[:, t].reshape((-1,) + (1,) * (src.ndim - 1))
        acc += src[idx] * kt                      # int32, as Resample.c's ss0
    out = np.clip(acc >> _PRECISION_BITS, 0, 255).astype(np.uint8)
    return np.ascontiguousarray(np.moveaxis(out, 0, axis))


def resize_bicubic(img: np.ndarray, size) -> np.ndarray:
    """``Image.fromarray(img).resize((w, h), Image.BICUBIC)`` for ``size =
    (h, w)``: the horizontal pass first, each pass skipped when its size is
    unchanged (a copy when neither changes)."""
    _rgb(img)
    h, w = int(size[0]), int(size[1])
    if h < 1 or w < 1:
        raise ValueError(f"resize to {size}: sizes must be positive")
    out = img
    if w != img.shape[1]:
        out = _resample_axis(out, w, 1)
    if h != img.shape[0]:
        out = _resample_axis(out, h, 0)
    return np.array(out, copy=True) if out is img else out


# ---------------------------------------------------------------------------
# affine transforms and rotation (Geometry.c, ImagingGenericTransform)
# ---------------------------------------------------------------------------

def _bicubic_1d(v1, v2, v3, v4, d):
    """Geometry.c's ``BICUBIC`` macro, in its order of operations (f64)."""
    p1 = v2
    p2 = -v1 + v3
    p3 = 2.0 * (v1 - v2) + v3 - v4
    p4 = -v1 + v2 - v3 + v4
    return p1 + d * (p2 + d * (p3 + d * p4))


def affine(img: np.ndarray, matrix, fill=(0, 0, 0), resample: int = BILINEAR) -> np.ndarray:
    """``Image.transform(img.size, Image.AFFINE, matrix, resample,
    fillcolor=fill)``: the output pixel centre ``(x + .5, y + .5)`` goes
    through ``matrix`` in f64; a point outside ``[0, W) x [0, H)`` keeps
    ``fill``; otherwise bilinear (truncated to uint8) or bicubic (clamped,
    then truncated) interpolation with the edges clamped."""
    _rgb(img)
    if resample not in (BILINEAR, BICUBIC):
        raise ValueError(f"resample {resample}: only BILINEAR (2) and BICUBIC (3) "
                         "are reproduced")
    a0, a1, a2, a3, a4, a5 = (float(v) for v in matrix[:6])
    h, w = img.shape[:2]
    yy, xx = np.meshgrid(np.arange(h, dtype=np.float64) + 0.5,
                         np.arange(w, dtype=np.float64) + 0.5, indexing="ij")
    xin = a0 * xx + a1 * yy + a2
    yin = a3 * xx + a4 * yy + a5
    inside = (xin >= 0.0) & (xin < w) & (yin >= 0.0) & (yin < h)
    xin, yin = xin - 0.5, yin - 0.5
    x0, y0 = np.floor(xin), np.floor(yin)
    dx, dy = (xin - x0)[..., None], (yin - y0)[..., None]
    x0, y0 = x0.astype(np.int64), y0.astype(np.int64)
    src = img.astype(np.float64)

    def px(y, x):
        return src[np.clip(y, 0, h - 1), np.clip(x, 0, w - 1)]

    if resample == BILINEAR:
        def row(y):
            a, b = px(y, x0), px(y, x0 + 1)
            return a + (b - a) * dx
        v1, v2 = row(y0), row(y0 + 1)
        v = v1 + (v2 - v1) * dy
        out = v.astype(np.uint8)                 # (UINT8) truncation
    else:
        def row(y):
            return _bicubic_1d(px(y, x0 - 1), px(y, x0), px(y, x0 + 1), px(y, x0 + 2), dx)
        v = _bicubic_1d(row(y0 - 1), row(y0), row(y0 + 1), row(y0 + 2), dy)
        out = np.where(v <= 0.0, 0.0, np.where(v >= 255.0, 255.0, v)).astype(np.uint8)
    fill = np.asarray(fill, np.uint8).reshape(1, 1, 3)
    return np.where(inside[..., None], out, fill)


def rotate(img: np.ndarray, degrees: float, fill=(0, 0, 0), resample: int = BILINEAR) -> np.ndarray:
    """``Image.rotate(degrees, resample, fillcolor=fill)`` (``expand=False``,
    counter-clockwise about the centre): Pillow's shortcuts for 0, 180 and,
    on a square image, 90 and 270 degrees, else its matrix through
    :func:`affine`."""
    _rgb(img)
    angle = degrees % 360.0
    h, w = img.shape[:2]
    if angle == 0:
        return img.copy()
    if angle == 180:
        return np.ascontiguousarray(img[::-1, ::-1])
    if angle in (90, 270) and w == h:
        return np.ascontiguousarray(np.rot90(img, 1 if angle == 90 else -1))
    cx, cy = w / 2, h / 2
    a = -math.radians(angle)
    m = [round(math.cos(a), 15), round(math.sin(a), 15), 0.0,
         round(-math.sin(a), 15), round(math.cos(a), 15), 0.0]
    m[2] = m[0] * -cx + m[1] * -cy + m[2]
    m[5] = m[3] * -cx + m[4] * -cy + m[5]
    m[2] += cx
    m[5] += cy
    return affine(img, m, fill, resample)


# ---------------------------------------------------------------------------
# point operations (ImageOps' lookup tables)
# ---------------------------------------------------------------------------

def _apply_luts(img: np.ndarray, luts) -> np.ndarray:
    """``Image.point`` with a table a channel; an entry past [0, 255] is
    clamped, as Pillow converts the list."""
    out = np.empty_like(img)
    for c in range(3):
        out[..., c] = np.clip(np.asarray(luts[c]), 0, 255).astype(np.uint8)[img[..., c]]
    return out


def _histograms(img: np.ndarray):
    return [np.bincount(img[..., c].ravel(), minlength=256).tolist() for c in range(3)]


def autocontrast(img: np.ndarray) -> np.ndarray:
    """``ImageOps.autocontrast(img)`` (no cutoff): each channel's darkest
    value to 0 and lightest to 255 through ``int(i * scale + offset)``."""
    luts = []
    for h in _histograms(_rgb(img)):
        lo = next((i for i in range(256) if h[i]), 255)
        hi = next((i for i in range(255, -1, -1) if h[i]), 0)
        if hi <= lo:
            luts.append(list(range(256)))
            continue
        scale = 255.0 / (hi - lo)
        offset = -lo * scale
        luts.append([min(255, max(0, int(i * scale + offset))) for i in range(256)])
    return _apply_luts(img, luts)


def equalize(img: np.ndarray) -> np.ndarray:
    """``ImageOps.equalize(img)``: each channel through its cumulative
    histogram, in integer steps as ImageOps computes them."""
    luts = []
    for h in _histograms(_rgb(img)):
        histo = [v for v in h if v]
        step = (sum(histo) - histo[-1]) // 255 if len(histo) > 1 else 0
        if not step:
            luts.append(list(range(256)))
            continue
        lut, n = [], step // 2
        for i in range(256):
            lut.append(n // step)
            n = n + h[i]
        luts.append(lut)
    return _apply_luts(img, luts)


def invert(img: np.ndarray) -> np.ndarray:
    """``ImageOps.invert``."""
    return 255 - _rgb(img)


def posterize(img: np.ndarray, bits: int) -> np.ndarray:
    """``ImageOps.posterize(img, bits)``: keep the ``bits`` high bits."""
    mask = ~(2 ** (8 - int(bits)) - 1)
    lut = [i & mask for i in range(256)]
    return _apply_luts(_rgb(img), [lut] * 3)


def solarize(img: np.ndarray, threshold: int) -> np.ndarray:
    """``ImageOps.solarize(img, threshold)``: ``255 - v`` where ``v >=
    threshold``."""
    lut = [i if i < threshold else 255 - i for i in range(256)]
    return _apply_luts(_rgb(img), [lut] * 3)


# ---------------------------------------------------------------------------
# enhancement (Blend.c, Convert.c, Filter.c) and the four ImageEnhance ops
# ---------------------------------------------------------------------------

def to_gray(img: np.ndarray) -> np.ndarray:
    """``img.convert("L")`` (ITU-R 601-2 luma in 16-bit fixed point) as an
    [H, W] uint8 array."""
    c = _rgb(img).astype(np.int32)
    return ((c[..., 0] * 19595 + c[..., 1] * 38470 + c[..., 2] * 7471 + 0x8000)
            >> 16).astype(np.uint8)


def blend(a: np.ndarray, b: np.ndarray, alpha: float) -> np.ndarray:
    """``Image.blend(a, b, alpha)``: ``a + alpha * (b - a)`` in f32 with
    ``alpha`` rounded to f32; truncated for alpha in [0, 1], clamped to
    [0, 255] and truncated otherwise."""
    alpha32 = np.float32(alpha)
    diff = (b.astype(np.int32) - a.astype(np.int32)).astype(np.float32)
    temp = a.astype(np.float32) + alpha32 * diff
    if 0.0 <= alpha32 <= 1.0:
        return temp.astype(np.uint8)
    return np.where(temp <= 0.0, 0.0, np.where(temp >= 255.0, 255.0, temp)).astype(np.uint8)


def smooth(img: np.ndarray) -> np.ndarray:
    """``img.filter(ImageFilter.SMOOTH)``: the 3x3 kernel (1 1 1 / 1 5 1 /
    1 1 1) / 13 in f32, row below, row, row above, rounded half up and
    clamped; the one-pixel border copied (an image under 3 pixels either
    way is copied whole)."""
    _rgb(img)
    h, w = img.shape[:2]
    if h < 3 or w < 3:
        return img.copy()
    k1 = np.float32(1) / np.float32(13)
    k5 = np.float32(5) / np.float32(13)
    f = img.astype(np.float32)

    def row(r, mid):
        return (f[r, :-2] * k1 + f[r, 1:-1] * mid) + f[r, 2:] * k1

    ss = row(slice(2, None), k1)
    ss = ss + row(slice(1, -1), k5)
    ss = ss + row(slice(None, -2), k1)
    inner = np.where(ss <= 0.0, 0, np.where(ss >= 255.0, 255,
                                           (ss.astype(np.float64) + 0.5).astype(np.int64)))
    out = img.copy()
    out[1:-1, 1:-1] = inner.astype(np.uint8)
    return out


def enhance_color(img: np.ndarray, factor: float) -> np.ndarray:
    """``ImageEnhance.Color(img).enhance(factor)``."""
    gray = np.repeat(to_gray(img)[..., None], 3, axis=2)
    return blend(gray, img, factor)


def enhance_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    """``ImageEnhance.Contrast(img).enhance(factor)``: against a flat image
    of the gray image's mean, ``int(mean + 0.5)``."""
    gray = to_gray(img)
    total = int(np.bincount(gray.ravel(), minlength=256) @ np.arange(256))
    mean = int(float(total) / gray.size + 0.5)
    return blend(np.full_like(img, mean), img, factor)


def enhance_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    """``ImageEnhance.Brightness(img).enhance(factor)``."""
    return blend(np.zeros_like(img), img, factor)


def enhance_sharpness(img: np.ndarray, factor: float) -> np.ndarray:
    """``ImageEnhance.Sharpness(img).enhance(factor)``."""
    return blend(smooth(img), img, factor)


# ---------------------------------------------------------------------------
# decoders: PNG and 24-bit BMP, as Image.open(path).convert("RGB")
# ---------------------------------------------------------------------------

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _unfilter_scanline(kind: int, line: bytearray, prior: bytearray, bpp: int) -> None:
    """Undo one PNG filter in place (PNG spec section 9)."""
    n = len(line)
    if kind == 0:
        return
    if kind == 1:
        for i in range(bpp, n):
            line[i] = (line[i] + line[i - bpp]) & 0xFF
    elif kind == 2:
        for i in range(n):
            line[i] = (line[i] + prior[i]) & 0xFF
    elif kind == 3:
        for i in range(n):
            left = line[i - bpp] if i >= bpp else 0
            line[i] = (line[i] + ((left + prior[i]) >> 1)) & 0xFF
    elif kind == 4:
        for i in range(n):
            a = line[i - bpp] if i >= bpp else 0
            b = prior[i]
            c = prior[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            line[i] = (line[i] + pred) & 0xFF
    else:
        raise ValueError(f"PNG filter type {kind} is not defined")


def decode_png(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A non-interlaced PNG of colour type 0, 2, 3, 4 or 6 at 8 bits (gray
    and palette also at 1, 2 and 4) as RGB uint8 HWC: gray replicated, a
    palette looked up, alpha dropped, as Pillow's ``convert("RGB")``.
    Raises ``ValueError`` naming any other case (16-bit samples,
    interlacing, a palette index past the palette)."""
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{name}: not a PNG file")
    pos, ihdr, palette, idat = len(PNG_SIGNATURE), None, None, []
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{name}: PNG without an IHDR chunk")
    width, height, depth, color, _, _, interlace = ihdr
    if color not in _PNG_CHANNELS:
        raise ValueError(f"{name}: PNG colour type {color} is not defined")
    if depth != 8 and not (color in (0, 3) and depth in (1, 2, 4)):
        raise ValueError(f"{name}: {depth}-bit PNG of colour type {color} is not "
                         "reproduced (8-bit, or 1/2/4-bit gray or palette)")
    if interlace:
        raise ValueError(f"{name}: interlaced PNG is not reproduced")
    bpp = _PNG_CHANNELS[color]
    stride = (width * bpp * depth + 7) // 8
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < height * (stride + 1):
        raise ValueError(f"{name}: PNG image data is truncated")
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(height, stride + 1)
    kinds = rows[:, 0]
    if not kinds.any():
        pix = rows[:, 1:]
    else:
        out = bytearray(height * stride)
        prior = bytearray(stride)
        step = max(1, bpp * depth // 8)
        for y in range(height):
            line = bytearray(rows[y, 1:].tobytes())
            _unfilter_scanline(int(kinds[y]), line, prior, step)
            out[y * stride:(y + 1) * stride] = line
            prior = line
        pix = np.frombuffer(bytes(out), np.uint8).reshape(height, stride)
    if depth < 8:                         # samples packed from the high bit
        pix = np.unpackbits(pix, axis=1).reshape(height, stride * 8 // depth, depth)
        pix = (pix * (1 << np.arange(depth - 1, -1, -1, dtype=np.uint8))).sum(
            axis=2, dtype=np.uint8)[:, :width]
        if color == 0:                    # Pillow's L;1 / L;2 / L;4 unpacking
            pix = pix * np.uint8(255 // ((1 << depth) - 1))
    pix = pix.reshape(height, width, bpp)
    if color == 2:
        rgb = pix
    elif color == 6:
        rgb = pix[..., :3]
    elif color in (0, 4):
        rgb = np.repeat(pix[..., :1], 3, axis=2)
    else:
        if palette is None:
            raise ValueError(f"{name}: palette PNG without a PLTE chunk")
        index = pix[..., 0]
        if int(index.max()) >= len(palette):
            raise ValueError(f"{name}: palette index {int(index.max())} past the "
                             f"{len(palette)}-entry palette is not reproduced")
        rgb = palette[index]
    return np.ascontiguousarray(rgb, np.uint8)


def decode_bmp(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """An uncompressed 24-bit BMP (BITMAPINFOHEADER or its V4 / V5 forms,
    bottom-up or top-down) as RGB uint8 HWC.  Raises ``ValueError`` naming
    any other kind."""
    if data[:2] != b"BM" or len(data) < 30:
        raise ValueError(f"{name}: not a BMP file")
    offset, header = struct.unpack("<I", data[10:14])[0], struct.unpack("<I", data[14:18])[0]
    if header not in (40, 108, 124):
        raise ValueError(f"{name}: BMP header of {header} bytes is not reproduced")
    width, height, _, bits, compression = struct.unpack("<iiHHI", data[18:34])
    if bits != 24 or compression != 0:
        raise ValueError(f"{name}: {bits}-bit BMP with compression {compression} is not "
                         "reproduced (24-bit uncompressed only)")
    if width <= 0 or height == 0:
        raise ValueError(f"{name}: BMP of {width} x {height} pixels")
    stride = (width * 3 + 3) // 4 * 4
    rows = abs(height)
    if len(data) < offset + rows * stride:
        raise ValueError(f"{name}: BMP pixel data is truncated")
    pix = np.frombuffer(data, np.uint8, rows * stride, offset).reshape(rows, stride)
    pix = pix[:, :width * 3].reshape(rows, width, 3)[..., ::-1]
    if height > 0:
        pix = pix[::-1]
    return np.ascontiguousarray(pix)
