"""MP4 video files on numpy and the standard library: an MPEG-4 Part 2
Visual (Simple Profile) encoder in an ISO BMFF container, the stream
that OpenCV's `VideoWriter` writes for the fourcc `mp4v`.

* Every VOP is an I-VOP, one video packet (resync markers off): intra
  DC prediction from the left / upper neighbour with the standard's DC
  scaler, `ac_pred_flag = 0` (the zigzag scan), the intra 3-D VLC table
  (last, run, level) with its three escapes, H.263 quantisation at one
  fixed quantiser (`QUANTISER`).
* Colour is BT.601 limited range (stated in the visual object header),
  4:2:0 with each chroma sample the mean of its 2x2 luma sites. Frames are
  padded to whole 16x16 macroblocks by repeating the last row and column;
  the VOL carries the true size.
* The container: `ftyp`, `mdat` (the VOPs, each a sync sample starting
  with a VOP start code), `moov` with one video track (`tkhd`, `mdhd` at
  a timescale of the frame rate, `hdlr vide`, `vmhd`, `dinf`, and an
  `stbl` with an `mp4v` sample entry whose `esds` holds object type 0x20
  and the VOS / VO / VOL headers, `stts`, `stss`, `stsc`, `stsz`,
  `stco`).

`Mp4Writer` writes frames as they come (the `mdat` first, the sizes and
offsets in `moov` at `close`), as `cv2.VideoWriter` does: an odd width or
height is cut to even, dropping the last column or row, and a frame whose
size (cut to even) differs from the first is dropped (`write` returns
False).
"""

from __future__ import annotations

import struct
from typing import List, Optional, Sequence, Tuple

import numpy as np

QUANTISER = 2  # vop_quant of every VOP (1..31)

VOS_START, VISUAL_OBJECT_START, VOP_START = 0x1B0, 0x1B5, 0x1B6
VO_START, VOL_START = 0x100, 0x120

# The zigzag scan (ac_pred_flag = 0): natural index at each position.
_ZIGZAG = np.array(sorted(range(64), key=lambda i: (
    i // 8 + i % 8, i // 8 if (i // 8 + i % 8) % 2 else -(i // 8))))
# The orthonormal 8-point DCT-II (the standard's F(0,0) = 8 x the mean).
_DCT = np.array([[(np.sqrt(0.5) if u == 0 else 1.0) * 0.5
                  * np.cos((2 * x + 1) * u * np.pi / 16)
                  for x in range(8)] for u in range(8)])

# Table B-6: mcbpc of an intra macroblock (type 3) by cbpc, (code, bits).
_MCBPC_I = ((1, 1), (1, 3), (2, 3), (3, 3))
# Table B-8: cbpy of an intra macroblock by cbpy.
_CBPY = ((3, 4), (5, 5), (4, 5), (9, 4), (3, 5), (7, 4), (2, 6), (11, 4),
         (2, 5), (3, 6), (5, 4), (10, 4), (4, 4), (8, 4), (6, 4), (3, 2))
# Tables B-13 / B-14: dct_dc_size_luminance / _chrominance by size.
_DC_LUM = ((3, 3), (3, 2), (2, 2), (2, 3), (1, 3), (1, 4), (1, 5), (1, 6),
           (1, 7), (1, 8), (1, 9), (1, 10), (1, 11))
_DC_CHROM = ((3, 2), (2, 2), (1, 2), (1, 3), (1, 4), (1, 5), (1, 6),
             (1, 7), (1, 8), (1, 9), (1, 10), (1, 11), (1, 12))
# Table B-16: the intra TCOEF VLCs (the sign bit follows each), listed
# by last, then run, the levels 1, 2, ... of each run in turn.
_INTRA_VLC = {
    (0, 0): [(0x2, 2), (0x6, 3), (0xF, 4), (0xD, 5), (0xC, 5), (0x15, 6),
             (0x13, 6), (0x12, 6), (0x17, 7), (0x1F, 8), (0x1E, 8),
             (0x1D, 8), (0x25, 9), (0x24, 9), (0x23, 9), (0x21, 9),
             (0x21, 10), (0x20, 10), (0xF, 10), (0xE, 10), (0x7, 11),
             (0x6, 11), (0x20, 11), (0x21, 11), (0x50, 12), (0x51, 12),
             (0x52, 12)],
    (0, 1): [(0xE, 4), (0x14, 6), (0x16, 7), (0x1C, 8), (0x20, 9),
             (0x1F, 9), (0xD, 10), (0x22, 11), (0x53, 12), (0x55, 12)],
    (0, 2): [(0xB, 5), (0x15, 7), (0x1E, 9), (0xC, 10), (0x56, 12)],
    (0, 3): [(0x11, 6), (0x1B, 8), (0x1D, 9), (0xB, 10)],
    (0, 4): [(0x10, 6), (0x22, 9), (0xA, 10)],
    (0, 5): [(0xD, 6), (0x1C, 9), (0x8, 10)],
    (0, 6): [(0x12, 7), (0x1B, 9), (0x54, 12)],
    (0, 7): [(0x14, 7), (0x1A, 9), (0x57, 12)],
    (0, 8): [(0x19, 8), (0x9, 10)],
    (0, 9): [(0x18, 8), (0x23, 11)],
    (0, 10): [(0x17, 8)], (0, 11): [(0x19, 9)], (0, 12): [(0x18, 9)],
    (0, 13): [(0x7, 10)], (0, 14): [(0x58, 12)],
    (1, 0): [(0x7, 4), (0xC, 6), (0x16, 8), (0x17, 9), (0x6, 10),
             (0x5, 11), (0x4, 11), (0x59, 12)],
    (1, 1): [(0xF, 6), (0x16, 9), (0x5, 10)],
    (1, 2): [(0xE, 6), (0x4, 10)],
    (1, 3): [(0x11, 7), (0x24, 11)], (1, 4): [(0x10, 7), (0x25, 11)],
    (1, 5): [(0x13, 7), (0x5A, 12)], (1, 6): [(0x15, 8), (0x5B, 12)],
    (1, 7): [(0x14, 8)], (1, 8): [(0x13, 8)], (1, 9): [(0x1A, 8)],
    (1, 10): [(0x15, 9)], (1, 11): [(0x14, 9)], (1, 12): [(0x13, 9)],
    (1, 13): [(0x12, 9)], (1, 14): [(0x11, 9)], (1, 15): [(0x26, 11)],
    (1, 16): [(0x27, 11)], (1, 17): [(0x5C, 12)], (1, 18): [(0x5D, 12)],
    (1, 19): [(0x5E, 12)], (1, 20): [(0x5F, 12)],
}
_ESCAPE = (0x3, 7)
_MAX_LEVEL = 2047  # escape 3 carries 12-bit levels


def _vlc_arrays():
    """The table as dense arrays: code and length (0: absent) by [last,
    run, |level|], LMAX by [last, run] and RMAX by [last, |level|]."""
    code = np.zeros((2, 64, _MAX_LEVEL + 1), np.int64)
    length = np.zeros_like(code)
    lmax = np.zeros((2, 64), np.int64)
    rmax = np.full((2, _MAX_LEVEL + 1), -1, np.int64)
    for (last, run), entries in _INTRA_VLC.items():
        for level, (c, n) in enumerate(entries, 1):
            code[last, run, level], length[last, run, level] = c, n
            rmax[last, level] = max(rmax[last, level], run)
        lmax[last, run] = len(entries)
    return code, length, lmax, rmax


_VLC_CODE, _VLC_LEN, _LMAX, _RMAX = _vlc_arrays()


def dc_scaler(q: int, luminance: bool) -> int:
    """Table 7-1: the intra DC scaler at quantiser q."""
    if q <= 4:
        return 8
    if luminance:
        return 2 * q if q <= 8 else (q + 8 if q <= 24 else 2 * q - 16)
    return (q + 13) // 2 if q <= 24 else q - 6


class BitWriter:
    """(code, length) pairs in order, packed MSB first at `tobytes`."""

    def __init__(self):
        self.codes: List[np.ndarray] = []
        self.lengths: List[np.ndarray] = []
        self.bits = 0

    def put(self, code: int, n: int) -> None:
        self.put_many(np.array([code], np.int64), np.array([n], np.int64))

    def put_many(self, codes: np.ndarray, lengths: np.ndarray) -> None:
        self.codes.append(np.asarray(codes, np.int64))
        self.lengths.append(np.asarray(lengths, np.int64))
        self.bits += int(np.sum(lengths))

    def start_code(self, value: int) -> None:
        self.put(value, 32)

    def next_start_code(self) -> None:
        """A zero bit, then ones to the byte boundary (1-8 bits)."""
        n = 8 - self.bits % 8
        self.put((1 << (n - 1)) - 1, n)

    def tobytes(self) -> bytes:
        if self.bits % 8:
            raise ValueError("the bitstream does not end on a byte")
        codes = np.concatenate(self.codes) if self.codes else np.zeros(0)
        lengths = (np.concatenate(self.lengths) if self.lengths
                   else np.zeros(0, np.int64))
        keep = lengths > 0
        codes, lengths = codes[keep].astype(np.int64), lengths[keep]
        owner = np.repeat(np.arange(len(codes)), lengths)
        pos = np.arange(self.bits) - np.repeat(np.cumsum(lengths) - lengths,
                                               lengths)
        bits = (codes[owner] >> (lengths[owner] - 1 - pos)) & 1
        return np.packbits(bits.astype(np.uint8)).tobytes()


def profile_level(width: int, height: int) -> int:
    """Simple Profile's profile_and_level_indication for the frame's
    macroblock count (L1, L3, L4a, L5, L6; L6 past its 3600)."""
    mbs = -(-width // 16) * -(-height // 16)
    for limit, level in ((99, 0x01), (396, 0x03), (1200, 0x04),
                         (1620, 0x05)):
        if mbs <= limit:
            return level
    return 0x06


def time_increment_bits(resolution: int) -> int:
    return max(1, (resolution - 1).bit_length())


def config_headers(width: int, height: int, fps: int) -> bytes:
    """The VOS, visual object, VO and VOL headers (the decoder-specific
    info of the `esds`)."""
    if not (0 < width < 8192 and 0 < height < 8192):
        raise ValueError(f"an MPEG-4 VOL cannot hold {width}x{height}")
    if not 0 < fps < 65536:
        raise ValueError(f"vop_time_increment_resolution {fps} out of range")
    bw = BitWriter()
    bw.start_code(VOS_START)
    bw.put(profile_level(width, height), 8)
    bw.start_code(VISUAL_OBJECT_START)
    bw.put(0, 1)  # is_visual_object_identifier
    bw.put(1, 4)  # visual_object_type: video
    bw.put(1, 1)  # video_signal_type
    bw.put(5, 3)  # video_format: unspecified
    bw.put(0, 1)  # video_range: limited (16-235)
    bw.put(1, 1)  # colour_description
    for v in (6, 6, 6):  # primaries, transfer, matrix: SMPTE 170M (BT.601)
        bw.put(v, 8)
    bw.next_start_code()
    bw.start_code(VO_START)
    bw.start_code(VOL_START)
    for value, n in (
            (0, 1),  # random_accessible_vol
            (1, 8),  # video_object_type_indication: Simple
            (0, 1),  # is_object_layer_identifier (verid 1)
            (1, 4),  # aspect_ratio_info: square pixels
            (1, 1),  # vol_control_parameters
            (1, 2),  # chroma_format: 4:2:0
            (1, 1),  # low_delay
            (0, 1),  # vbv_parameters
            (0, 2),  # video_object_layer_shape: rectangular
            (1, 1), (fps, 16), (1, 1),  # vop_time_increment_resolution
            (0, 1),  # fixed_vop_rate
            (1, 1), (width, 13), (1, 1), (height, 13), (1, 1),
            (0, 1),  # interlaced
            (1, 1),  # obmc_disable
            (0, 1),  # sprite_enable
            (0, 1),  # not_8_bit
            (0, 1),  # quant_type: H.263
            (1, 1),  # complexity_estimation_disable
            (1, 1),  # resync_marker_disable
            (0, 1),  # data_partitioned
            (0, 1)):  # scalability
        bw.put(value, n)
    bw.next_start_code()
    return bw.tobytes()


def rgb_to_yuv420(rgb: np.ndarray):
    """uint8 [H, W, 3] RGB -> BT.601 limited-range Y [H', W'], Cb, Cr
    [H'/2, W'/2] (uint8), padded to whole macroblocks by edge repeat."""
    h, w = rgb.shape[:2]
    x = np.pad(rgb, ((0, (-h) % 16), (0, (-w) % 16), (0, 0)), mode="edge")
    r, g, b = (x[..., k].astype(np.float64) for k in range(3))
    y = 16 + (65.481 * r + 128.553 * g + 24.966 * b) / 255
    cb = 128 + (-37.797 * r - 74.203 * g + 112.0 * b) / 255
    cr = 128 + (112.0 * r - 93.786 * g - 18.214 * b) / 255

    def half(c):
        return c.reshape(c.shape[0] // 2, 2, c.shape[1] // 2, 2).mean((1, 3))

    def u8(c):
        return np.clip(np.rint(c), 0, 255).astype(np.uint8)

    return u8(y), u8(half(cb)), u8(half(cr))


def _blocks(plane: np.ndarray) -> np.ndarray:
    """[H, W] -> [H/8, W/8, 8, 8] blocks."""
    h, w = plane.shape
    return plane.reshape(h // 8, 8, w // 8, 8).transpose(0, 2, 1, 3)


def quantise(f: np.ndarray, q: int, scaler_l: int, scaler_c: int,
             chroma: np.ndarray) -> np.ndarray:
    """DCT coefficients [N, 64] -> levels: DC by its scaler (rounded);
    AC to the H.263 reconstruction |F| = q (2|L| + 1) - (1 if q even)
    nearest it (zero where zero is nearer)."""
    lv = np.zeros(f.shape, np.int64)
    scaler = np.where(chroma, scaler_c, scaler_l)
    lv[:, 0] = np.rint(f[:, 0] / scaler)
    a = np.abs(f[:, 1:])
    even = 1 if q % 2 == 0 else 0
    lvl = np.maximum(np.rint((a + even - q) / (2 * q)), 1)
    recon = q * (2 * lvl + 1) - even
    lvl = np.where(np.abs(a - recon) < a, lvl, 0)
    lv[:, 1:] = np.sign(f[:, 1:]) * np.minimum(lvl, _MAX_LEVEL)
    return lv


def frame_levels(rgb: np.ndarray, q: int = QUANTISER):
    """A frame's quantised levels [n_mb, 6, 64] (natural order; blocks Y0
    Y1 Y2 Y3 Cb Cr of each macroblock, macroblocks in raster order) and
    its size in macroblocks (mby, mbx)."""
    y, cb, cr = rgb_to_yuv420(rgb)
    mby, mbx = y.shape[0] // 16, y.shape[1] // 16
    yb = _blocks(y).reshape(mby, 2, mbx, 2, 8, 8).transpose(0, 2, 1, 3, 4, 5)
    blocks = np.concatenate([
        yb.reshape(mby, mbx, 4, 8, 8),
        _blocks(cb)[:, :, None], _blocks(cr)[:, :, None]], 2)
    f = np.einsum("ux,nbxy,vy->nbuv", _DCT,
                  blocks.reshape(mby * mbx, 6, 8, 8).astype(np.float64),
                  _DCT).reshape(-1, 64)
    chroma = np.tile(np.array([0, 0, 0, 0, 1, 1], bool), mby * mbx)
    lv = quantise(f, q, dc_scaler(q, True), dc_scaler(q, False), chroma)
    return lv.reshape(mby * mbx, 6, 64), (mby, mbx)


def _dc_differentials(dc: np.ndarray, mby: int, mbx: int, q: int):
    """[n_mb, 6] DC levels -> the coded differentials (the standard's
    adaptive prediction from the left or upper block, F = level x scaler,
    1024 outside the VOP)."""
    diff = np.zeros_like(dc)
    luma = dc[:, :4].reshape(mby, mbx, 2, 2).transpose(0, 2, 1, 3).reshape(
        2 * mby, 2 * mbx)
    planes = [(luma, dc_scaler(q, True), lambda d: d.reshape(
        mby, 2, mbx, 2).transpose(0, 2, 1, 3).reshape(-1, 4), slice(0, 4))]
    for k in (4, 5):
        planes.append((dc[:, k].reshape(mby, mbx), dc_scaler(q, False),
                       lambda d: d.reshape(-1, 1), slice(k, k + 1)))
    for lv, s, back, cols in planes:
        f = np.pad(lv * s, ((1, 0), (1, 0)), constant_values=1024)
        a, b, c = f[1:, :-1], f[:-1, :-1], f[:-1, 1:]
        pred = np.where(np.abs(a - b) < np.abs(b - c), c, a)
        diff[:, cols] = back(lv - (pred + s // 2) // s)
    return diff


def _dc_codes(diff: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Each block's dct_dc_size VLC, differential and marker bit as one
    (code, length)."""
    size = np.zeros_like(diff)
    nz = diff != 0
    size[nz] = np.floor(np.log2(np.abs(diff[nz]))).astype(np.int64) + 1
    lum = np.array(_DC_LUM)
    chrom = np.array(_DC_CHROM)
    is_c = np.zeros(diff.shape, bool)
    is_c[:, 4:] = True
    vlc = np.where(is_c, chrom[size, 0], lum[size, 0])
    vlen = np.where(is_c, chrom[size, 1], lum[size, 1])
    bits = np.where(diff >= 0, diff, diff + (1 << size) - 1)
    code = (vlc << size) | bits
    length = vlen + size
    marker = size > 8
    return (np.where(marker, code * 2 + 1, code),
            np.where(marker, length + 1, length))


def _ac_codes(last, run, level):
    """(code, length) of each AC event: the VLC and sign, else escape 1
    (level - LMAX), escape 2 (run - RMAX - 1), escape 3 (fixed length)."""
    a = np.abs(level)
    sign = (level < 0).astype(np.int64)
    esc, esc_len = _ESCAPE
    # ESC '11' last run(6) marker level(12, two's complement) marker.
    code3 = ((esc << 2 | 3) << 21) | (last << 20) | (run << 14) | (1 << 13) \
        | ((level & 0xFFF) << 1) | 1
    code, length = code3, np.full_like(a, 7 + 2 + 1 + 6 + 1 + 12 + 1)
    r1 = run - _RMAX[last, a] - 1
    ok2 = (r1 >= 0) & (_VLC_LEN[last, np.maximum(r1, 0), a] > 0)
    c2, n2 = (_VLC_CODE[last, np.maximum(r1, 0), a],
              _VLC_LEN[last, np.maximum(r1, 0), a])
    code = np.where(ok2, (((esc << 2 | 2) << n2 | c2) << 1) | sign, code)
    length = np.where(ok2, esc_len + 2 + n2 + 1, length)
    a1 = a - _LMAX[last, run]
    ok1 = (a1 >= 1) & (_VLC_LEN[last, run, np.clip(a1, 0, None)] > 0)
    c1, n1 = (_VLC_CODE[last, run, np.clip(a1, 0, None)],
              _VLC_LEN[last, run, np.clip(a1, 0, None)])
    code = np.where(ok1, (((esc << 1) << n1 | c1) << 1) | sign, code)
    length = np.where(ok1, esc_len + 1 + n1 + 1, length)
    c0, n0 = _VLC_CODE[last, run, a], _VLC_LEN[last, run, a]
    ok0 = n0 > 0
    code = np.where(ok0, (c0 << 1) | sign, code)
    length = np.where(ok0, n0 + 1, length)
    return code, length


def encode_vop(levels: np.ndarray, mb_shape: Tuple[int, int], frame: int,
               fps: int, q: int = QUANTISER) -> bytes:
    """One I-VOP from its levels [n_mb, 6, 64] (`frame_levels`): the
    header at time `frame / fps` (modulo_time_base counts the seconds
    since the previous frame's), then the macroblocks."""
    mby, mbx = mb_shape
    n_mb = mby * mbx
    bw = BitWriter()
    bw.start_code(VOP_START)
    bw.put(0, 2)  # vop_coding_type: I
    seconds = frame // fps - (frame - 1) // fps if frame > 0 else 0
    bw.put((1 << (seconds + 1)) - 2, seconds + 1)  # modulo_time_base
    bw.put(1, 1)
    bw.put(frame % fps, time_increment_bits(fps))
    bw.put(1, 1)
    bw.put(1, 1)  # vop_coded
    bw.put(0, 3)  # intra_dc_vlc_thr: the DC VLC always
    bw.put(q, 5)  # vop_quant

    ac = levels[:, :, _ZIGZAG[1:]]  # the AC levels in zigzag order
    coded = (ac != 0).any(-1)  # [n_mb, 6]
    cbp = (coded * (1 << np.arange(5, -1, -1))).sum(-1)
    mcbpc = np.array(_MCBPC_I)[cbp & 3]
    cbpy = np.array(_CBPY)[cbp >> 2]
    # mcbpc, ac_pred_flag = 0, cbpy.
    head_code = ((mcbpc[:, 0] << 1) << cbpy[:, 1]) | cbpy[:, 0]
    head_len = mcbpc[:, 1] + 1 + cbpy[:, 1]
    dc_code, dc_len = _dc_codes(_dc_differentials(levels[:, :, 0], mby, mbx,
                                                  q))

    blk, pos = np.nonzero(ac.reshape(n_mb * 6, 63))
    lvl = ac.reshape(n_mb * 6, 63)[blk, pos]
    first = np.ones(len(blk), bool)
    first[1:] = blk[1:] != blk[:-1]
    prev = np.where(first, -1, np.concatenate([[0], pos[:-1]]))
    run = pos - prev - 1
    last = np.ones(len(blk), np.int64)
    last[:-1] = blk[1:] != blk[:-1]
    ev_code, ev_len = _ac_codes(last, run, lvl)

    # Order: per macroblock its header, then per block its DC and events.
    keys = np.concatenate([np.arange(n_mb) * 6 * 3,
                           np.arange(n_mb * 6) * 3 + 1, blk * 3 + 2])
    order = np.argsort(keys, kind="stable")
    bw.put_many(np.concatenate([head_code, dc_code.reshape(-1),
                                ev_code])[order],
                np.concatenate([head_len, dc_len.reshape(-1),
                                ev_len])[order])
    bw.next_start_code()
    return bw.tobytes()


# --- ISO BMFF ---------------------------------------------------------------

_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def box(kind: bytes, *parts: bytes) -> bytes:
    payload = b"".join(parts)
    return struct.pack(">I", 8 + len(payload)) + kind + payload


def full_box(kind: bytes, version: int, flags: int, *parts: bytes) -> bytes:
    return box(kind, struct.pack(">I", (version << 24) | flags), *parts)


def _descriptor(tag: int, payload: bytes) -> bytes:
    n, size = len(payload), []
    while True:
        size.insert(0, n & 0x7F)
        n >>= 7
        if not n:
            break
    size = [b | 0x80 for b in size[:-1]] + size[-1:]
    return bytes([tag] + size) + payload


def esds(config: bytes, bitrate: int, buffer_size: int) -> bytes:
    dec_config = _descriptor(0x04, bytes([0x20, (0x04 << 2) | 1])
                             + struct.pack(">I", buffer_size)[1:]
                             + struct.pack(">II", bitrate, bitrate)
                             + _descriptor(0x05, config))
    es = _descriptor(0x03, struct.pack(">HB", 1, 0) + dec_config
                     + _descriptor(0x06, b"\x02"))
    return full_box(b"esds", 0, 0, es)


def moov(width: int, height: int, fps: int, sizes: Sequence[int],
         mdat_offset: int, config: bytes) -> bytes:
    n = len(sizes)
    movie_duration = round(n * 1000 / fps)
    mvhd = full_box(b"mvhd", 0, 0, struct.pack(
        ">IIII", 0, 0, 1000, movie_duration), struct.pack(">IH", 0x10000,
                                                           0x100),
        bytes(10), _MATRIX, bytes(24), struct.pack(">I", 2))
    tkhd = full_box(b"tkhd", 0, 3, struct.pack(
        ">IIIII", 0, 0, 1, 0, movie_duration), bytes(8),
        struct.pack(">HHHH", 0, 0, 0, 0), _MATRIX,
        struct.pack(">II", width << 16, height << 16))
    mdhd = full_box(b"mdhd", 0, 0, struct.pack(">IIII", 0, 0, fps, n),
                    struct.pack(">HH", 0x55C4, 0))  # language 'und'
    hdlr = full_box(b"hdlr", 0, 0, struct.pack(">I", 0), b"vide",
                    bytes(12), b"VideoHandler\x00")
    vmhd = full_box(b"vmhd", 0, 1, bytes(8))
    dinf = box(b"dinf", full_box(b"dref", 0, 0, struct.pack(">I", 1),
                                 full_box(b"url ", 0, 1)))
    total = sum(sizes)
    seconds = max(n / fps, 1e-9)
    bitrate = int(total * 8 / seconds)
    entry = box(b"mp4v", bytes(6), struct.pack(">H", 1), bytes(16),
                struct.pack(">HH", width, height),
                struct.pack(">II", 0x480000, 0x480000), bytes(4),
                struct.pack(">H", 1), bytes(32),
                struct.pack(">Hh", 0x18, -1),
                esds(config, bitrate, max(sizes, default=0)))
    one = int(n > 0)  # one chunk of n samples (none without frames)
    stbl = box(b"stbl",
               full_box(b"stsd", 0, 0, struct.pack(">I", 1), entry),
               full_box(b"stts", 0, 0, struct.pack(">I", one),
                        struct.pack(">II", n, 1) * one),
               full_box(b"stss", 0, 0, struct.pack(f">I{n}I", n,
                                                   *range(1, n + 1))),
               full_box(b"stsc", 0, 0, struct.pack(">I", one),
                        struct.pack(">III", 1, n, 1) * one),
               full_box(b"stsz", 0, 0, struct.pack(f">II{n}I", 0, n,
                                                   *sizes)),
               full_box(b"stco", 0, 0, struct.pack(">I", one),
                        struct.pack(">I", mdat_offset) * one))
    minf = box(b"minf", vmhd, dinf, stbl)
    trak = box(b"trak", tkhd, box(b"mdia", mdhd, hdlr, minf))
    return box(b"moov", mvhd, trak)


FTYP = box(b"ftyp", b"isom", struct.pack(">I", 0x200), b"isomiso2mp41")


class Mp4Writer:
    """Write RGB uint8 frames [H, W, 3] to an `mp4v` MP4 at `fps`, as
    `cv2.VideoWriter(path, fourcc('mp4v'), fps, (width, height))` does:
    the size is cut to even, a frame of another size is dropped."""

    def __init__(self, path: str, fps: int, size: Tuple[int, int]):
        if int(fps) != fps or fps <= 0:
            raise ValueError(f"fps must be a positive integer, got {fps}")
        self.fps = int(fps)
        self.width, self.height = size[0] & ~1, size[1] & ~1
        if self.width <= 0 or self.height <= 0:
            raise ValueError(f"no video of size {size}")
        self.config = config_headers(self.width, self.height, self.fps)
        self.sizes: List[int] = []
        self.f = open(path, "wb")
        self.f.write(FTYP)
        self.mdat_at = self.f.tell()
        self.f.write(struct.pack(">I", 0) + b"mdat")

    def write(self, rgb: np.ndarray) -> bool:
        """Encode one frame; False (and nothing written) where its size,
        cut to even, is not the video's."""
        rgb = np.asarray(rgb)
        if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
            raise ValueError(f"frames are uint8 [H, W, 3], got {rgb.dtype} "
                             f"{rgb.shape}")
        h, w = rgb.shape[:2]
        if (w & ~1, h & ~1) != (self.width, self.height):
            return False
        levels, mb = frame_levels(rgb[: self.height, : self.width])
        vop = encode_vop(levels, mb, len(self.sizes), self.fps)
        self.f.write(vop)
        self.sizes.append(len(vop))
        return True

    def close(self) -> None:
        if self.f is None:
            return
        end = self.f.tell()
        if end - self.mdat_at >= 1 << 32:
            raise ValueError("the frames pass 4 GiB, which a 32-bit mdat "
                             "and stco cannot address")
        self.f.seek(self.mdat_at)
        self.f.write(struct.pack(">I", end - self.mdat_at))
        self.f.seek(end)
        self.f.write(moov(self.width, self.height, self.fps, self.sizes,
                          self.mdat_at + 8, self.config))
        self.f.close()
        self.f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
