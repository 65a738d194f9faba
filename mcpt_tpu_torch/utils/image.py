"""Image IO (counterpart of mcpt_tpu/utils/image.py; csrt
src/utils/image_io.cpp).

PNG via PIL with the reference's exact sRGB encode (image_io.cpp:31-37:
linear <= 0.0031308 -> 12.92x, else 1.055x^(1/2.4) - 0.055, clamp, *255).
EXR via a minimal pure-Python OpenEXR codec (scanline, ZIP/ZIPS/none)
for HDR output and checkpoints — no external EXR library exists in this
environment.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

# ---------------------------------------------------------------------------
# sRGB


def linear_to_srgb(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    lo = 12.92 * x
    hi = 1.055 * np.power(np.maximum(x, 1e-12), 1.0 / 2.4) - 0.055
    return np.where(x <= 0.0031308, lo, hi)


def srgb_to_linear(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    lo = x / 12.92
    hi = np.power((x + 0.055) / 1.055, 2.4)
    return np.where(x <= 0.04045, lo, hi)


def write_png(path: str, linear_rgb: np.ndarray) -> None:
    """Write linear-light [H, W, 3] float32 as an sRGB PNG."""
    from PIL import Image

    srgb = np.clip(linear_to_srgb(linear_rgb), 0.0, 1.0)
    u8 = (srgb * 255.0 + 0.5).astype(np.uint8)  # round: white -> 255
    Image.fromarray(u8, "RGB").save(path)


def read_png_linear(path: str) -> np.ndarray:
    """Read a PNG and decode sRGB -> linear [H, W, 3] float32."""
    from PIL import Image

    img = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    return srgb_to_linear(img)


def read_image_linear(path: str, gamma: float = 2.2) -> np.ndarray:
    """LDR/HDR read with gamma->linear like csrt image_io.cpp:55-172.

    PNG/JPG decode sRGB; .hdr decodes Radiance RGBE via PIL-free reader;
    .exr uses our EXR codec.
    """
    lower = path.lower()
    if lower.endswith(".exr"):
        return read_exr(path)
    if lower.endswith(".hdr"):
        return read_hdr(path)
    return read_png_linear(path)


# ---------------------------------------------------------------------------
# Radiance .hdr (RGBE)


def read_hdr(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    # header
    pos = 0
    width = height = None
    while True:
        e = data.index(b"\n", pos)
        line = data[pos:e]
        pos = e + 1
        if line.startswith(b"-Y"):
            parts = line.split()
            height = int(parts[1])
            width = int(parts[3])
            break
    rgbe = np.zeros((height, width, 4), np.uint8)
    for y in range(height):
        # adaptive RLE scanline
        if data[pos : pos + 2] == b"\x02\x02":
            pos += 4
            row = np.zeros((4, width), np.uint8)
            for c in range(4):
                x = 0
                while x < width:
                    count = data[pos]
                    pos += 1
                    if count > 128:
                        row[c, x : x + count - 128] = data[pos]
                        pos += 1
                        x += count - 128
                    else:
                        row[c, x : x + count] = np.frombuffer(
                            data, np.uint8, count, pos
                        )
                        pos += count
                        x += count
            rgbe[y] = row.T
        else:  # flat
            row = np.frombuffer(data, np.uint8, width * 4, pos).reshape(width, 4)
            pos += width * 4
            rgbe[y] = row
    exp = rgbe[..., 3].astype(np.int32) - 136  # 128 + 8 mantissa bits
    scale = np.ldexp(1.0, exp).astype(np.float32)
    out = rgbe[..., :3].astype(np.float32) * scale[..., None]
    out[rgbe[..., 3] == 0] = 0.0
    return out


# ---------------------------------------------------------------------------
# Minimal OpenEXR: scanline, float32/half, compression none(0)/ZIPS(2)/ZIP(3)

_EXR_MAGIC = 0x01312F76


def _exr_attr(name: bytes, atype: bytes, payload: bytes) -> bytes:
    return name + b"\0" + atype + b"\0" + struct.pack("<i", len(payload)) + payload


def write_exr(path: str, img: np.ndarray) -> None:
    """Write [H, W, 3] float32 as a ZIP-compressed scanline EXR."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    block = 16  # ZIP: 16 scanlines per chunk

    channels = b""
    for name in (b"B", b"G", b"R"):  # alphabetical, float32 = type 2
        channels += name + b"\0" + struct.pack("<iBBBBii", 2, 0, 0, 0, 0, 1, 1)
    channels += b"\0"

    header = b""
    header += _exr_attr(b"channels", b"chlist", channels)
    header += _exr_attr(b"compression", b"compression", b"\x03")  # ZIP
    header += _exr_attr(
        b"dataWindow", b"box2i", struct.pack("<4i", 0, 0, w - 1, h - 1)
    )
    header += _exr_attr(
        b"displayWindow", b"box2i", struct.pack("<4i", 0, 0, w - 1, h - 1)
    )
    header += _exr_attr(b"lineOrder", b"lineOrder", b"\0")
    header += _exr_attr(
        b"pixelAspectRatio", b"float", struct.pack("<f", 1.0)
    )
    header += _exr_attr(
        b"screenWindowCenter", b"v2f", struct.pack("<2f", 0.0, 0.0)
    )
    header += _exr_attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0))
    header += b"\0"

    n_chunks = (h + block - 1) // block
    chunks = []
    for ci in range(n_chunks):
        y0 = ci * block
        rows = img[y0 : y0 + block]
        # channel-interleaved by scanline: for each row, B then G then R planes
        raw = b""
        for r in rows:
            raw += r[:, 2].tobytes() + r[:, 1].tobytes() + r[:, 0].tobytes()
        chunks.append(struct.pack("<i", y0) + _exr_pack(raw))

    with open(path, "wb") as f:
        f.write(struct.pack("<II", _EXR_MAGIC, 2))
        f.write(header)
        offset_table_pos = f.tell()
        # chunk layout: [y:int][size:int][payload]; our `chunks` hold y+payload
        offset = offset_table_pos + 8 * n_chunks
        offsets = []
        for c in chunks:
            offsets.append(offset)
            offset += 4 + 4 + (len(c) - 4)
        f.write(struct.pack(f"<{n_chunks}Q", *offsets))
        for c in chunks:
            y_bytes, payload = c[:4], c[4:]
            f.write(y_bytes + struct.pack("<i", len(payload)) + payload)


def _exr_pack(raw: bytes) -> bytes:
    # EXR ZIP predictor: delta-encode then split odd/even bytes, then zlib
    arr = np.frombuffer(raw, np.uint8).astype(np.int16)
    d = np.empty_like(arr)
    d[0] = arr[0]
    d[1:] = arr[1:] - arr[:-1] + 128 + 256
    d = (d & 0xFF).astype(np.uint8)
    half = (len(d) + 1) // 2
    inter = np.empty_like(d)
    inter[:half] = d[0::2]
    inter[half:] = d[1::2]
    packed = zlib.compress(inter.tobytes())
    return packed if len(packed) < len(raw) else raw


def _exr_unpack(payload: bytes, expect: int) -> bytes:
    if len(payload) == expect:
        return payload
    data = np.frombuffer(zlib.decompress(payload), np.uint8)
    half = (len(data) + 1) // 2
    out = np.empty_like(data)
    out[0::2] = data[:half]
    out[1::2] = data[half:]
    # undo predictor: x[i] = x[i-1] + d[i] - 128 - 256 (mod 256)
    deltas = out.astype(np.int64) - 128 - 256
    deltas[0] = out[0]
    rec = (np.cumsum(deltas) % 256).astype(np.uint8)
    return rec.tobytes()


def read_exr(path: str) -> np.ndarray:
    """Read a scanline EXR (none/ZIPS/ZIP compression, float/half)."""
    with open(path, "rb") as f:
        data = f.read()
    magic, _version = struct.unpack_from("<II", data, 0)
    assert magic == _EXR_MAGIC, "not an EXR file"
    pos = 8
    attrs = {}
    while data[pos] != 0:
        e = data.index(b"\0", pos)
        name = data[pos:e].decode()
        pos = e + 1
        e = data.index(b"\0", pos)
        pos = e + 1
        (size,) = struct.unpack_from("<i", data, pos)
        pos += 4
        attrs[name] = data[pos : pos + size]
        pos += size
    pos += 1

    x0, y0, x1, y1 = struct.unpack("<4i", attrs["dataWindow"])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    comp = attrs["compression"][0]
    if comp not in (0, 2, 3, 4):
        raise NotImplementedError(
            f"EXR compression {comp} unsupported (none/ZIPS/ZIP/PIZ only)"
        )
    block = {0: 1, 2: 1, 3: 16, 4: 32}[comp]

    # channel list
    chans = []
    cpos = 0
    cl = attrs["channels"]
    while cl[cpos] != 0:
        e = cl.index(b"\0", cpos)
        cname = cl[cpos:e].decode()
        cpos = e + 1
        (ctype,) = struct.unpack_from("<i", cl, cpos)
        cpos += 16
        chans.append((cname, ctype))  # 1 = half, 2 = float

    n_chunks = (h + block - 1) // block
    offsets = struct.unpack_from(f"<{n_chunks}Q", data, pos)

    out = {c: np.zeros((h, w), np.float32) for c, _ in chans}
    bpp = {1: 2, 2: 4}
    for off in offsets:
        (y,) = struct.unpack_from("<i", data, off)
        (size,) = struct.unpack_from("<i", data, off + 4)
        payload = data[off + 8 : off + 8 + size]
        rows = min(block, y1 - y + 1)
        if comp == 4:  # PIZ via the native decoder (half channels only)
            from mcpt_tpu_torch import native

            if any(t != 1 for _, t in chans):
                raise NotImplementedError("PIZ with float32 channels")
            planes = native.piz_uncompress(
                payload, [w] * len(chans), [rows] * len(chans)
            )
            for (cname, _), plane in zip(chans, planes):
                out[cname][y - y0 : y - y0 + rows] = plane.view(
                    np.float16
                ).astype(np.float32)
            continue
        expect = sum(w * bpp[t] for _, t in chans) * rows
        raw = _exr_unpack(payload, expect)
        rpos = 0
        for r in range(rows):
            for cname, ctype in chans:
                nb = w * bpp[ctype]
                buf = raw[rpos : rpos + nb]
                rpos += nb
                if ctype == 1:
                    vals = np.frombuffer(buf, np.float16).astype(np.float32)
                else:
                    vals = np.frombuffer(buf, np.float32)
                out[cname][y - y0 + r] = vals

    names = [c for c, _ in chans]
    if all(k in names for k in ("R", "G", "B")):
        return np.stack([out["R"], out["G"], out["B"]], axis=-1)
    return np.stack([out[c] for c in names], axis=-1)
