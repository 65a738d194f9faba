"""mcpt_tpu_torch/utils/image.py and the port's PIZ decoder (csrc/piz.c
through mcpt_tpu_torch/native.py) against mcpt_tpu/utils/image.py and
mcpt_tpu/native.

Both packages are the same numpy and C code on the host, so everything
here is held EQUAL, with no tolerance:

* the bytes `write_png` and `write_exr` write;
* the arrays `read_exr` (none, ZIPS, ZIP and PIZ; half and float),
  `read_hdr` (flat and run-length scanlines) and `read_image_linear`
  return on files the reference writes or this test writes;
* the PIZ decoder's return codes and outputs on the same payloads, valid,
  corrupt and truncated.  The valid payloads come from a small Huffman
  encoder written here (the decoder's canonical code, zero-run table
  codes and its run-length symbol); the decoder's wavelet and LUT stages
  run on whatever the Huffman stage yields.
"""

import ctypes
import struct

import numpy as np
import pytest

from mcpt_tpu import native as jnative
from mcpt_tpu.utils import image as jimg
from mcpt_tpu_torch import native
from mcpt_tpu_torch.utils import image as timg


def _img(h=21, w=13, seed=0):
    r = np.random.default_rng(seed)
    img = r.uniform(0.0, 2.0, size=(h, w, 3)).astype(np.float32)
    img[0, 0] = [0.0, 0.001, 0.0031308]  # both sides of the sRGB knee
    return img


def test_srgb_curves_equal():
    x = np.linspace(0.0, 2.0, 1001, dtype=np.float32)
    np.testing.assert_array_equal(timg.linear_to_srgb(x), jimg.linear_to_srgb(x))
    np.testing.assert_array_equal(timg.srgb_to_linear(x), jimg.srgb_to_linear(x))


@pytest.mark.parametrize("ext", ["png", "exr"])
def test_writers_write_the_reference_bytes(tmp_path, ext):
    img = _img()
    a, b = tmp_path / f"port.{ext}", tmp_path / f"ref.{ext}"
    getattr(timg, f"write_{ext}")(str(a), img)
    getattr(jimg, f"write_{ext}")(str(b), img)
    assert a.read_bytes() == b.read_bytes()
    got = timg.read_image_linear(str(a))
    np.testing.assert_array_equal(got, jimg.read_image_linear(str(b)))
    if ext == "exr":
        np.testing.assert_array_equal(got, img)


# ---------------------------------------------------------------- EXR files


def _attr(name, atype, payload):
    return name + b"\0" + atype + b"\0" + struct.pack("<i", len(payload)) + payload


def write_exr_variant(path, planes, types, comp, chunk_payload=None):
    """A scanline EXR of named planes ({name: [H, W]}), each channel half
    (1) or float (2), compression none (0), ZIPS (2), ZIP (3) or PIZ (4,
    whose chunk payloads `chunk_payload(y0, rows)` gives)."""
    names = sorted(planes)
    h, w = planes[names[0]].shape
    block = {0: 1, 2: 1, 3: 16, 4: 32}[comp]
    chl = b"".join(n.encode() + b"\0" + struct.pack("<iBBBBii", types[n], 0, 0,
                                                    0, 0, 1, 1) for n in names)
    header = (_attr(b"channels", b"chlist", chl + b"\0")
              + _attr(b"compression", b"compression", bytes([comp]))
              + _attr(b"dataWindow", b"box2i", struct.pack("<4i", 0, 0, w - 1, h - 1))
              + _attr(b"displayWindow", b"box2i", struct.pack("<4i", 0, 0, w - 1, h - 1))
              + _attr(b"lineOrder", b"lineOrder", b"\0") + b"\0")
    chunks = []
    for y0 in range(0, h, block):
        rows = min(block, h - y0)
        if comp == 4:
            payload = chunk_payload(y0, rows)
        else:
            raw = b"".join(
                planes[n][y].astype(np.float16 if types[n] == 1 else np.float32).tobytes()
                for y in range(y0, y0 + rows) for n in names)
            payload = raw if comp == 0 else jimg._exr_pack(raw)
        chunks.append(struct.pack("<ii", y0, len(payload)) + payload)
    start = 8 + len(header) + 8 * len(chunks)
    offsets, pos = [], start
    for c in chunks:
        offsets.append(pos)
        pos += len(c)
    path.write_bytes(struct.pack("<II", 20000630, 2) + header
                     + struct.pack(f"<{len(chunks)}Q", *offsets) + b"".join(chunks))


@pytest.mark.parametrize("comp", [0, 2, 3])
@pytest.mark.parametrize("dtype", ["half", "float", "mixed"])
def test_read_exr_equal(tmp_path, comp, dtype):
    img = _img(h=37, w=11, seed=comp)
    planes = {"R": img[..., 0], "G": img[..., 1], "B": img[..., 2]}
    t = {"half": 1, "float": 2}
    types = ({n: t[dtype] for n in planes} if dtype != "mixed"
             else {"R": 1, "G": 2, "B": 1})
    path = tmp_path / "img.exr"
    write_exr_variant(path, planes, types, comp)
    got = timg.read_exr(str(path))
    np.testing.assert_array_equal(got, jimg.read_exr(str(path)))
    want = np.stack([planes[c].astype(np.float16 if types[c] == 1 else np.float32)
                     .astype(np.float32) for c in "RGB"], -1)
    np.testing.assert_array_equal(got, want)


def test_read_exr_other_channels(tmp_path):
    """Channels other than R, G, B come back in the header's order."""
    y = _img(h=5, w=7)[..., 0]
    path = tmp_path / "y.exr"
    write_exr_variant(path, {"Y": y, "A": y * 0.5}, {"Y": 2, "A": 2}, 0)
    got = timg.read_exr(str(path))
    assert got.shape == (5, 7, 2)
    np.testing.assert_array_equal(got, jimg.read_exr(str(path)))


# ---------------------------------------------------------------- Radiance HDR


def write_hdr(path, rgbe, rle_rows=()):
    """A Radiance .hdr of raw RGBE bytes [H, W, 4]; rows in `rle_rows` are
    written as adaptive run-length scanlines (a run of each channel's
    first byte, then literals), the others flat."""
    h, w, _ = rgbe.shape
    out = b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n" + f"-Y {h} +X {w}\n".encode()
    for y in range(h):
        if y not in rle_rows:
            out += rgbe[y].tobytes()
            continue
        out += bytes([2, 2, w >> 8, w & 0xFF])
        for c in range(4):
            row = rgbe[y, :, c]
            run = 3
            out += bytes([128 + run, row[0]])
            out += bytes([w - run]) + row[run:].tobytes()
    path.write_bytes(out)


def test_read_hdr_equal(tmp_path):
    r = np.random.default_rng(4)
    h, w = 6, 9
    rgbe = r.integers(0, 256, size=(h, w, 4), dtype=np.uint8)
    rgbe[..., 3] = r.integers(120, 140, size=(h, w))
    rgbe[2, 3, 3] = 0  # a zero exponent is black
    for y in (1, 4):  # the run-length rows' runs are constant
        rgbe[y, :3] = rgbe[y, 0]
    path = tmp_path / "sky.hdr"
    write_hdr(path, rgbe, rle_rows=(1, 4))
    got = timg.read_image_linear(str(path))
    np.testing.assert_array_equal(got, jimg.read_image_linear(str(path)))
    np.testing.assert_array_equal(got, timg.read_hdr(str(path)))
    assert got.shape == (h, w, 3) and (got[2, 3] == 0).all() and got.max() > 0


# ---------------------------------------------------------------- PIZ


def _put(bits, value, n):
    bits.extend((value >> (n - 1 - i)) & 1 for i in range(n))


def _bytes(bits):
    bits = bits + [0] * (-len(bits) % 8)
    return bytes(int("".join(map(str, bits[i:i + 8])), 2)
                 for i in range(0, len(bits), 8))


def _canonical(lengths):
    """{symbol: (code, length)} by piz.c's canonical_code_table."""
    n = [0] * 59
    for l in lengths.values():
        n[l] += 1
    c = 0
    for i in range(58, 0, -1):
        n[i], c = c, (c + n[i]) >> 1
    codes = {}
    for s in sorted(lengths):
        l = lengths[s]
        if l:
            codes[s] = (n[l], l)
            n[l] += 1
    return codes


def huffman_payload(symbols, lengths, runs=()):
    """The Huffman stage of a PIZ chunk: im, iM, the table of code
    lengths over [im, iM] (zero runs as the short and long run codes),
    then `symbols` coded, with (position, count) `runs` of the previous
    symbol by the run-length symbol iM.  Returns (bytes, nBits)."""
    im, iM = min(lengths), max(lengths)
    table = []
    s = im
    while s <= iM:
        l = lengths.get(s, 0)
        run = 0
        while s + run <= iM and lengths.get(s + run, 0) == 0:
            run += 1
        if run >= 6:
            take = min(run, 255 + 6)
            _put(table, 63, 6)
            _put(table, take - 6, 8)
            s += take
        elif run >= 2:
            _put(table, 59 + run - 2, 6)
            s += run
        else:
            _put(table, l, 6)
            s += 1
    codes = _canonical({k: v for k, v in lengths.items()})
    data = []
    runs = dict(runs)
    for i, sym in enumerate(symbols):
        _put(data, *codes[sym])
        if i in runs:
            _put(data, *codes[iM])
            _put(data, runs[i], 8)
    head = struct.pack("<5I", im, iM, 0, len(data), 0)
    return head + _bytes(table) + _bytes(data), len(data)


def piz_payload(n_values, seed, bitmap_range=(0, 40), slack=512):
    """One valid PIZ chunk payload of `n_values` outputs: a bitmap over
    [lo, hi], then the Huffman stage.  `slack` zero bytes follow the
    Huffman bytes (inside the payload, outside its stated length), so that
    a corrupt table that shifts the data never reads past the buffer."""
    r = np.random.default_rng(seed)
    # 0..5, 71, 72 of length 3 (a complete code), 6..70 absent: a long
    # zero run in the table; 72 = iM is the run-length symbol
    lengths = {s: 3 for s in range(6)}
    lengths.update({71: 3, 72: 3, 70: 0})
    alphabet = list(range(6)) + [71]
    n_runs = 3
    run_counts = r.integers(2, 9, size=n_runs)
    n_syms = n_values - int(run_counts.sum())
    symbols = [alphabet[k] for k in r.integers(0, len(alphabet), size=n_syms)]
    where = sorted(r.choice(np.arange(1, n_syms), size=n_runs, replace=False))
    huff, _ = huffman_payload(symbols, lengths, zip(where, run_counts.tolist()))
    lo, hi = bitmap_range
    bitmap = r.integers(0, 256, size=hi - lo + 1, dtype=np.uint8).tobytes()
    return (struct.pack("<HH", lo, hi) + bitmap + struct.pack("<i", len(huff))
            + huff + b"\0" * slack), 4 + len(bitmap) + 4


def _ref_decode(payload, nx, ny):
    """The reference decoder's return code and output on one payload."""
    lib = jnative.piz()
    total = sum(a * b for a, b in zip(nx, ny))
    out = np.zeros(total, np.uint16)
    rc = lib.piz_uncompress(
        payload, len(payload), len(nx), (ctypes.c_int * len(nx))(*nx),
        (ctypes.c_int * len(ny))(*ny),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint16)), total)
    return rc, out


def _assert_same_decode(payload, nx, ny):
    rc, out = native.piz_decode(payload, nx, ny)
    want_rc, want = _ref_decode(payload, nx, ny)
    assert rc == want_rc
    if rc == 0:
        np.testing.assert_array_equal(out, want)
    return rc


#: channel layouts of a chunk: (nx per channel, ny per channel)
LAYOUTS = [((7,), (5,)), ((6, 6, 6), (4, 4, 4)), ((9, 3), (2, 8))]


@pytest.mark.parametrize("layout", range(len(LAYOUTS)))
def test_piz_valid_payloads_decode_as_the_reference(layout):
    nx, ny = LAYOUTS[layout]
    n = sum(a * b for a, b in zip(nx, ny))
    for seed in range(4):
        payload, _ = piz_payload(n, seed, bitmap_range=(0, 40 + 700 * seed))
        assert _assert_same_decode(payload, nx, ny) == 0
    planes = native.piz_uncompress(payload, nx, ny)
    want = jnative.piz_uncompress(payload, nx, ny)
    for a, b in zip(planes, want):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_piz_corrupt_and_truncated_payloads_fail_as_the_reference():
    nx, ny = (6, 6, 6), (4, 4, 4)
    n = sum(a * b for a, b in zip(nx, ny))
    payload, huff_at = piz_payload(n, seed=11)
    (hlen,) = struct.unpack_from("<i", payload, huff_at - 4)
    codes = set()
    # cut anywhere: the bitmap, the length, the Huffman header or data
    for cut in range(0, huff_at + hlen, 3):
        codes.add(_assert_same_decode(payload[:cut], nx, ny))
    # fewer data bits than the output needs
    for drop in (1, 5, 17, 40):
        p = bytearray(payload)
        (nbits,) = struct.unpack_from("<I", p, huff_at + 12)
        struct.pack_into("<I", p, huff_at + 12, nbits - drop)
        codes.add(_assert_same_decode(bytes(p), nx, ny))
    # flipped bits in the bitmap, the table and the data (never in the
    # Huffman header's nBits, which bounds the decoder's reads)
    r = np.random.default_rng(5)
    region = [i for i in range(4, huff_at + hlen)
              if not huff_at - 4 <= i < huff_at + 20]
    for i in r.choice(region, size=120):
        p = bytearray(payload)
        p[i] ^= 1 << int(r.integers(0, 8))
        codes.add(_assert_same_decode(bytes(p), nx, ny))
    # header values out of range: the bitmap's end, im / iM, the length
    for field, at, fmt, value in (("bitmap end", 2, "<H", 9000),
                                  ("im", huff_at, "<I", 70000),
                                  ("iM", huff_at + 4, "<I", 70000),
                                  ("length", huff_at - 4, "<i", -1),
                                  ("length", huff_at - 4, "<i", 10),
                                  ("length", huff_at - 4, "<i", 1 << 20)):
        p = bytearray(payload)
        struct.pack_into(fmt, p, at, value)
        codes.add(_assert_same_decode(bytes(p), nx, ny))
    # the wrong output size for the payload's symbols: more, then fewer
    codes.add(_assert_same_decode(payload, (6, 6, 6), (4, 4, 5)))
    codes.add(_assert_same_decode(payload, (6, 6, 6), (4, 4, 3)))
    assert {-1, -2, -4, -5, -11, -12} <= codes
    with pytest.raises(ValueError, match="code -11"):
        native.piz_uncompress(payload[:10], nx, ny)


def test_read_exr_piz_equal(tmp_path):
    """A PIZ EXR (half R, G, B; 32-row chunks, the last short): the
    port's read_exr equals the reference's, through either decoder."""
    h, w = 45, 6
    rng = np.random.default_rng(2)
    planes = {c: rng.uniform(size=(h, w)).astype(np.float32) for c in "BGR"}
    payloads = {}

    def chunk(y0, rows):
        payloads[y0], _ = piz_payload(3 * w * rows, seed=y0,
                                      bitmap_range=(0, 8000))
        return payloads[y0]

    path = tmp_path / "piz.exr"
    write_exr_variant(path, planes, {c: 1 for c in planes}, 4, chunk)
    got = timg.read_exr(str(path))
    np.testing.assert_array_equal(got, jimg.read_exr(str(path)))
    assert got.shape == (h, w, 3)
    top = native.piz_uncompress(payloads[0], [w] * 3, [32] * 3)
    np.testing.assert_array_equal(got[:32, :, 0],
                                  top[2].view(np.float16).astype(np.float32))


def test_piz_library_builds_outside_the_package_sources():
    lib = native.library_path()
    native.piz()
    assert lib.exists() and lib.parent.parent.name == "_build"
    assert not list(native.PIZ_SOURCE.parent.glob("*.so"))
