"""Image decoding for the loaders (counterpart of
``da_detect_tpu/data/transforms.py::load_image_bgr``).

The JAX package decodes with ``cv2.imread``. A machine with a card may have
neither cv2 nor PIL, so the port carries its own PNG reader (stdlib ``zlib``
and numpy): 8-bit grey, grey + alpha, RGB and RGBA, not interlaced, all five
row filters. Cityscapes and its foggy and rainy renderings are PNG.

``DECODER`` is chosen once, when this module is imported: "cv2" when cv2 is
importable, else "png". The loaders record it in their stats. On a PNG both
give the same bytes; a file that is not a PNG needs cv2, and without it the
reader raises and names the file.

None (0), Sub (1) and Up (2) rows decode a row at a time with numpy. Average
(3) and Paeth (4) predict each pixel from the one to its left, so a row is
sequential; an image holding such rows is decoded by anti-diagonals instead:
pixel (r, x) depends on (r, x-1), (r-1, x) and (r-1, x-1), all on earlier
diagonals r + x, so each of the H + W - 1 diagonals is one vectorised step
over every row it crosses.

``write_png`` writes filter type 0 only (the smoke run's datasets).
``image_size`` reads a PNG's dimensions from its header (``ListDataset``).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

try:
    import cv2
except ImportError:
    cv2 = None

DECODER = "cv2" if cv2 is not None else "png"

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# colour type -> samples a pixel (8-bit): grey, RGB, grey + alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _chunks(data: bytes, path: str):
    pos = len(PNG_SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{path}: truncated PNG chunk {kind!r}")
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError(f"{path}: PNG without IEND")


def _unfilter_rows(filters: np.ndarray, raw: np.ndarray,
                   bpp: int) -> np.ndarray:
    """Filters 0-2 only: one row at a time, uint8 arithmetic wraps mod 256."""
    out = np.empty_like(raw)
    prev = np.zeros(raw.shape[1], np.uint8)
    for r, f in enumerate(filters):
        row = raw[r]
        if f == 1:
            row = np.cumsum(row.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif f == 2:
            row = row + prev
        out[r] = row
        prev = out[r]
    return out


def _unfilter_diagonals(filters: np.ndarray, raw: np.ndarray,
                        bpp: int) -> np.ndarray:
    """Any filters, by anti-diagonals. ``sk[t + 2, r + 1]`` holds pixel
    (r, t - r); the cells that stand for pixels off the image stay 0, which
    is what the filters read there."""
    h, stride = raw.shape
    w = stride // bpp
    diagonals = h + w - 1
    rr = np.arange(h)[:, None]
    xx = np.arange(w)[None, :]
    src = np.zeros((diagonals, h, bpp), np.int16)
    src[rr + xx, rr] = raw.reshape(h, w, bpp)
    sk = np.zeros((diagonals + 2, h + 1, bpp), np.int16)
    ft = filters.astype(np.int16)[:, None]
    zero = np.zeros((h, bpp), np.int16)
    for t in range(diagonals):
        lo, hi = max(0, t - w + 1), min(h - 1, t)
        n = hi - lo + 1
        a = sk[t + 1, lo + 1:hi + 2]       # left
        b = sk[t + 1, lo:hi + 1]           # up
        c = sk[t, lo:hi + 1]               # up-left
        pa = np.abs(b - c)
        pb = np.abs(a - c)
        pc = np.abs(a + b - 2 * c)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, c))
        pred = np.choose(ft[lo:hi + 1], (zero[:n], a, b, (a + b) >> 1, paeth))
        sk[t + 2, lo + 1:hi + 2] = (src[t, lo:hi + 1] + pred) & 0xFF
    return sk[rr + xx + 2, rr + 1].astype(np.uint8).reshape(h, stride)


def read_png(path: str) -> np.ndarray:
    """The PNG's pixels as uint8 [H, W, C] in the file's channel order
    (C = 1 grey, 2 grey + alpha, 3 RGB, 4 RGBA)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: PNG without IHDR")
    w, h, depth, colour, _, _, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0:
        raise ValueError(
            f"{path}: PNG of bit depth {depth}, colour type {colour}, "
            f"interlace {interlace}; the reader takes 8-bit grey, grey + "
            "alpha, RGB or RGBA, not interlaced")
    bpp = _CHANNELS[colour]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (1 + w * bpp):
        raise ValueError(f"{path}: {raw.size} image bytes for {w}x{h}x{bpp}")
    raw = raw.reshape(h, 1 + w * bpp)
    filters, rows = raw[:, 0], raw[:, 1:]
    if filters.max(initial=0) > 4:
        raise ValueError(f"{path}: unknown PNG row filter {filters.max()}")
    if filters.max(initial=0) <= 2:
        out = _unfilter_rows(filters, rows, bpp)
    else:
        out = _unfilter_diagonals(filters, rows, bpp)
    return out.reshape(h, w, bpp)


def png_to_bgr(pixels: np.ndarray) -> np.ndarray:
    """``read_png``'s pixels as cv2's ``IMREAD_COLOR`` gives them: BGR, grey
    repeated into three channels, alpha dropped."""
    c = pixels.shape[2]
    if c <= 2:
        return np.ascontiguousarray(np.repeat(pixels[:, :, :1], 3, axis=2))
    return np.ascontiguousarray(pixels[:, :, 2::-1])


def require_cv2(what: str):
    """The cv2 module, or raise naming ``what`` (a function that rasterizes
    or resizes masks) when cv2 is not importable."""
    if cv2 is None:
        raise RuntimeError(f"{what} needs cv2 (fillPoly, resize), which is "
                           "not importable here")
    return cv2


def load_image_bgr(path: str, decoder: str = DECODER) -> np.ndarray:
    """uint8 BGR [H, W, 3] (the Caffe2 convention) through ``decoder``."""
    if decoder == "cv2":
        img = cv2.imread(path, cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(path)
        return img
    if decoder != "png":
        raise ValueError(f"unknown image decoder {decoder!r}")
    with open(path, "rb") as f:
        if f.read(len(PNG_SIGNATURE)) != PNG_SIGNATURE:
            raise ValueError(f"{path}: not a PNG, and without cv2 only PNG "
                             "files can be decoded")
    return png_to_bgr(read_png(path))


def image_size(path: str) -> tuple[int, int]:
    """(width, height) of an image file without decoding it where it can:
    a PNG's from its IHDR chunk; another format through cv2 when it is
    importable (a decode), else raises naming the file."""
    with open(path, "rb") as f:
        head = f.read(len(PNG_SIGNATURE) + 16)
    if head.startswith(PNG_SIGNATURE):
        if head[12:16] != b"IHDR":
            raise ValueError(f"{path}: PNG without IHDR first")
        return struct.unpack(">II", head[16:24])
    if cv2 is None:
        raise ValueError(f"{path}: not a PNG, and without cv2 only PNG "
                         "files' sizes can be read")
    h, w = load_image_bgr(path, "cv2").shape[:2]
    return w, h


def write_png(path: str, image: np.ndarray, level: int = 6) -> None:
    """Write uint8 BGR [H, W, 3] (as RGB) or grey [H, W] as an 8-bit PNG,
    every row with filter type 0."""
    if image.dtype != np.uint8 or image.ndim not in (2, 3) or (
            image.ndim == 3 and image.shape[2] != 3):
        raise ValueError(f"write_png takes uint8 [H, W, 3] BGR or [H, W] "
                         f"grey, got {image.dtype} {image.shape}")
    h, w = image.shape[:2]
    if image.ndim == 2:
        colour, pixels = 0, image.reshape(h, w)
    else:
        colour, pixels = 2, image[:, :, ::-1].reshape(h, w * 3)
    rows = np.zeros((h, 1 + pixels.shape[1]), np.uint8)
    rows[:, 1:] = pixels

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    with open(path, "wb") as f:
        f.write(PNG_SIGNATURE
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, colour,
                                             0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
                + chunk(b"IEND", b""))
