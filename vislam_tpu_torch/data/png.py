"""A PNG codec for the dataset readers, with no OpenCV and no libpng.

Decoding: the chunks are parsed here, the image data inflated with the
standard library's zlib, and the rows unfiltered by a small C++ host
function (`csrc/png_unfilter.cpp`), built with g++ at first use into
`vislam_tpu_torch/_build/` and loaded with ctypes; `unfilter_plain` is its
numpy twin, which the tests hold it against. 8-bit grey, RGB and RGBA
images without interlacing are read; colour is converted to grey as
OpenCV's `imread(path, IMREAD_GRAYSCALE)` converts it (libpng's
rgb-to-grey with OpenCV's coefficients, truncated), so a colour dataset
(TUM RGB-D, KITTI `image_2`) reads the same grey values. Any other PNG
raises ValueError; nothing falls back to another decoder.

Encoding (`write_png`): 8-bit grey or RGB, filter type 0 on every row,
deflated with zlib; it writes the fixtures (`data/synthetic.py`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import tempfile
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}          # colour type -> samples per pixel
_COLOUR_NAMES = {0: "grey", 2: "RGB", 3: "palette", 4: "grey + alpha", 6: "RGBA"}
# libpng's rgb-to-grey weights for OpenCV's (0.299, 0.587) in 1/32768:
# red and green truncated from 29900 and 58700 per 100000, blue the rest.
_GREY_R, _GREY_G = 29900 * 32768 // 100000, 58700 * 32768 // 100000
_GREY_B = 32768 - _GREY_R - _GREY_G

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "png_unfilter.cpp")
_BUILD = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
_CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
_lib = None


def _library() -> ctypes.CDLL:
    """The unfilter library, compiled with g++ on first use (a file name
    carrying a hash of the source and the flags; built into a temporary
    name and renamed, so a concurrent or broken build never leaves a
    half-written library under the final name). A failed build raises."""
    global _lib
    if _lib is None:
        with open(_SRC, "rb") as f:
            tag = hashlib.sha256(f.read() + " ".join(_CXX_FLAGS).encode()).hexdigest()[:16]
        out = os.path.join(_BUILD, f"png_unfilter-{tag}.so")
        if not os.path.exists(out):
            cxx = shutil.which(os.environ.get("CXX", "g++"))
            if cxx is None:
                raise RuntimeError("g++ not found: the PNG unfilter is built from "
                                   f"{_SRC} at first use")
            os.makedirs(_BUILD, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD)
            os.close(fd)
            proc = subprocess.run([cxx, *_CXX_FLAGS, "-o", tmp, _SRC],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                os.unlink(tmp)
                raise RuntimeError(f"g++ failed building {_SRC}:\n{proc.stderr}")
            os.replace(tmp, out)
        lib = ctypes.CDLL(out)
        lib.png_unfilter.restype = ctypes.c_int
        lib.png_unfilter.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int]
        _lib = lib
    return _lib


def unfilter(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """Reconstruct the (height, stride) uint8 rows of inflated PNG data
    (each row a filter-type byte then `stride` bytes) with the C++ host
    function."""
    if len(raw) != height * (stride + 1):
        raise ValueError(f"PNG data holds {len(raw)} bytes, expected {height * (stride + 1)}")
    src = np.frombuffer(raw, np.uint8)
    out = np.empty((height, stride), np.uint8)
    rc = _library().png_unfilter(src.ctypes.data, out.ctypes.data, height, stride, bpp)
    if rc != 0:
        raise ValueError(f"PNG row {-rc - 1}: unknown filter type "
                         f"{src[(-rc - 1) * (stride + 1)]}")
    return out


def unfilter_plain(raw: bytes, height: int, stride: int, bpp: int) -> np.ndarray:
    """numpy twin of `unfilter`: None and Up whole rows, Sub as a running
    sum per channel, Average and Paeth one pixel at a time."""
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.int32)
    for y in range(height):
        kind, line = int(rows[y, 0]), rows[y, 1:].astype(np.int32)
        if kind == 0:
            cur = line
        elif kind == 1:
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif kind == 2:
            cur = (line + prior) & 0xFF
        elif kind in (3, 4):
            cur = line.copy()
            for x in range(0, stride, bpp):
                a = cur[x - bpp:x] if x else np.zeros(bpp, np.int32)
                b = prior[x:x + bpp]
                if kind == 3:
                    pred = (a + b) >> 1
                else:
                    c = prior[x - bpp:x] if x else np.zeros(bpp, np.int32)
                    p = a + b - c
                    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
                    pred = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
                cur[x:x + bpp] = (cur[x:x + bpp] + pred) & 0xFF
        else:
            raise ValueError(f"PNG row {y}: unknown filter type {kind}")
        out[y] = cur
        prior = cur
    return out


def _chunks(data: bytes, path: str):
    if data[:8] != _SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"{path}: truncated {kind.decode('latin-1')} chunk")
        yield kind, body
        pos += 12 + length
        if kind == b"IEND":
            return
    raise ValueError(f"{path}: no IEND chunk")


def decode_png(data: bytes, path: str = "<bytes>", unfilter_fn=None):
    """PNG bytes -> uint8 (H, W) grey, (H, W, 3) RGB or (H, W, 4) RGBA, as
    stored. unfilter_fn: `unfilter` (default) or `unfilter_plain`."""
    header, idat = None, []
    for kind, body in _chunks(data, path):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError(f"{path}: no IHDR chunk")
    width, height, depth, colour, compression, filtering, interlace = header
    if depth != 8 or colour not in _CHANNELS or interlace != 0 or compression or filtering:
        raise ValueError(
            f"{path}: unsupported PNG ({depth}-bit {_COLOUR_NAMES.get(colour, colour)}, "
            f"interlace {interlace}); the reader takes 8-bit grey, RGB or RGBA, "
            "not interlaced")
    ch = _CHANNELS[colour]
    rows = (unfilter_fn or unfilter)(zlib.decompress(b"".join(idat)), height, width * ch, ch)
    return rows.reshape(height, width, ch) if ch > 1 else rows


def to_grey(img: np.ndarray) -> np.ndarray:
    """uint8 grey, RGB or RGBA -> grey as OpenCV's IMREAD_GRAYSCALE gives it
    (alpha dropped; (r*R + g*G + b*B) >> 15 in libpng's integer weights)."""
    if img.ndim == 2:
        return img
    rgb = img[..., :3].astype(np.uint32)
    return ((_GREY_R * rgb[..., 0] + _GREY_G * rgb[..., 1] + _GREY_B * rgb[..., 2]) >> 15
            ).astype(np.uint8)


def read_png_grey(path: str) -> np.ndarray:
    """A PNG file as (H, W) uint8 grey (the readers' image loader)."""
    with open(path, "rb") as f:
        data = f.read()
    return to_grey(decode_png(data, path))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 (H, W) grey or (H, W, 3) RGB -> PNG bytes (filter type 0)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim not in (2, 3) or (img.ndim == 3 and img.shape[2] != 3):
        raise ValueError(f"write_png takes uint8 (H, W) or (H, W, 3), got {img.dtype} "
                         f"{img.shape}")
    height, width = img.shape[:2]
    colour = 0 if img.ndim == 2 else 2
    rows = np.concatenate([np.zeros((height, 1), np.uint8), img.reshape(height, -1)], axis=1)

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    return (_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, 8, colour, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes()))
            + chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    with open(path, "wb") as f:
        f.write(encode_png(img))
