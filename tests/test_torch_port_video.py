"""The port's video CLI (`cli/video.py`) and its `mp4v` writer
(`data/video.py`) against the JAX package's CLI (cv2.VideoWriter), both
files read back with `cv2.VideoCapture` (ffmpeg's MPEG-4 decoder): the
frame count, fps and size equal, each of the port's frames at least 34 dB
PSNR against the stitched source frame as `cv2.imread` gives it; the
intra VLC table against escape-3 codes through the same decoder; the
MP4 boxes.

The frames are render-like: colour that varies over tens of pixels,
texture and edges in the luminance. 4:2:0 drops colour detail finer than
2x2 pixels in both files alike (per-pixel colour noise costs both ~7 dB,
a colour gradient of ~20 levels a pixel ~4 dB): those cases are held by
the port's PSNR against the cv2 file's instead."""

import os
import struct

import numpy as np
import pytest

from consistentnerf_tpu.cli import video as jvideo
from consistentnerf_tpu_torch.cli import video as pvideo
from consistentnerf_tpu_torch.data import images, video
from torch_port_shared import _one_torch_thread  # noqa: F401

cv2 = pytest.importorskip("cv2")

PSNR_MIN = 34.0


def _render_like(seed, h, w):
    rng = np.random.RandomState(seed)
    y = np.linspace(0, 1, h)[:, None, None]
    x = np.linspace(0, 1, w)[None, :, None]
    f = rng.uniform(0.5, 2, (2, 3))  # colour cycles across the frame
    ph = rng.uniform(0, 2 * np.pi, (2, 3))
    img = (0.5 + 0.3 * np.sin(2 * np.pi * f[0] * x + ph[0])
           * np.cos(2 * np.pi * f[1] * y + ph[1])
           + 0.08 * rng.rand(h, w, 1) - 0.04)
    r0, c0 = rng.randint(0, h // 2), rng.randint(0, w // 2)
    img[r0:r0 + h // 4, c0:c0 + w // 4] -= 0.3  # a luminance edge
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def _depth_like(seed, h, w):
    rng = np.random.RandomState(seed)
    d = (np.linspace(0.2, 0.9, w)[None, :] * np.linspace(1, 0.6, h)[:, None]
         + 0.05 * rng.rand(h, w))
    return (np.clip(d, 0, 1) * 255).astype(np.uint8)


def _write_frames(d, n, h, w, depth, missing=()):
    d.mkdir()
    for i in range(n):
        cv2.imwrite(str(d / f"color_{i:03d}.png"),
                    _render_like(i, h, w)[..., ::-1])
        if depth and i not in missing:
            cv2.imwrite(str(d / f"depth_{i:03d}.png"), _depth_like(i, h, w))
    return d


def _stitched_sources(d, n):
    """What cv2.VideoWriter is handed (the JAX CLI's frames, BGR)."""
    colors = sorted(str(p) for p in d.glob("color_*.png"))[:n]
    side = os.path.isfile(colors[0].replace("color_", "depth_"))
    out = []
    for c in colors:
        img = cv2.imread(c)
        dp = c.replace("color_", "depth_")
        if side and os.path.isfile(dp):
            img = np.concatenate([img, cv2.imread(dp)], 1)
        out.append(img)
    return out


def _read(path):
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, f = cap.read()
        if not ok:
            break
        frames.append(f)
    info = (cap.get(cv2.CAP_PROP_FRAME_COUNT), cap.get(cv2.CAP_PROP_FPS),
            cap.get(cv2.CAP_PROP_FRAME_WIDTH),
            cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    cap.release()
    return frames, info


def psnr(a, b):
    mse = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / max(mse, 1e-12))


CASES = {
    "color_only": dict(n=4, h=96, w=128, depth=False),
    "with_depth": dict(n=4, h=96, w=128, depth=True),
    "odd_size": dict(n=3, h=97, w=127, depth=True),
    "missing_later_depth": dict(n=5, h=96, w=112, depth=True, missing=(2,)),
    "fps_2": dict(n=5, h=80, w=96, depth=False, fps=2),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cli_matches_jax(tmp_path, case, capsys):
    kw = dict(CASES[case])
    fps = kw.pop("fps", 30)
    d = _write_frames(tmp_path / "frames", **kw)
    jvideo.main([str(d), "--out", str(tmp_path / "jax.mp4"), "--fps",
                 str(fps)])
    pvideo.main([str(d), "--out", str(tmp_path / "port.mp4"), "--fps",
                 str(fps)])
    out = capsys.readouterr()
    lines = [x for x in out.out.splitlines() if x.startswith("wrote")]
    assert [x.split()[-2:] for x in lines] == [[f"({kw['n']}", "frames)"]] * 2
    jf, jinfo = _read(tmp_path / "jax.mp4")
    pf, pinfo = _read(tmp_path / "port.mp4")
    assert pinfo == jinfo and len(pf) == len(jf) == jinfo[0]
    assert pinfo[1] == fps
    # The frames cv2 kept: the sources whose size (cut to even) is the
    # first's, each cut to even.
    srcs = _stitched_sources(d, kw["n"])
    h0, w0 = srcs[0].shape[0] & ~1, srcs[0].shape[1] & ~1
    kept = [s[:h0, :w0] for s in srcs
            if (s.shape[0] & ~1, s.shape[1] & ~1) == (h0, w0)]
    assert len(kept) == len(pf)
    if "missing" in kw:
        assert len(pf) == kw["n"] - len(kw["missing"])
        assert "dropped" in out.err
    for i, (got, src) in enumerate(zip(pf, kept)):
        assert got.shape == src.shape
        assert psnr(got, src) >= PSNR_MIN, (i, psnr(got, src))


@pytest.mark.parametrize("kind", ["colour_noise", "steep_colour"])
def test_hard_colour_no_worse_than_cv2(tmp_path, kind):
    """Colour detail that 4:2:0 drops in both files (per-pixel colour
    noise; colour sines of 4-8 cycles across 64 pixels): the port's
    frames within 0.5 dB of cv2's file's, or better."""
    rng = np.random.RandomState(0)
    if kind == "colour_noise":
        frames = [np.clip(_render_like(i, 48, 64).astype(int)
                          + rng.randint(-12, 13, (48, 64, 3)), 0, 255)
                  .astype(np.uint8) for i in range(3)]
    else:
        x = np.arange(64)[None, :, None] / 64
        y = np.arange(48)[:, None, None] / 48
        frames = [(127.5 + 100 * np.sin(2 * np.pi * rng.uniform(4, 8, 3) * x)
                   * np.cos(2 * np.pi * rng.uniform(2, 4, 3) * y))
                  .astype(np.uint8) for _ in range(3)]
    with video.Mp4Writer(str(tmp_path / "port.mp4"), 30, (64, 48)) as w:
        for f in frames:
            assert w.write(f)
    cw = cv2.VideoWriter(str(tmp_path / "cv2.mp4"),
                         cv2.VideoWriter_fourcc(*"mp4v"), 30, (64, 48))
    for f in frames:
        cw.write(np.ascontiguousarray(f[..., ::-1]))
    cw.release()
    pf, _ = _read(tmp_path / "port.mp4")
    cf, _ = _read(tmp_path / "cv2.mp4")
    assert len(pf) == len(cf) == 3
    for p, c, f in zip(pf, cf, frames):
        assert psnr(p, f[..., ::-1]) >= psnr(c, f[..., ::-1]) - 0.5


def _mp4_of_vops(path, vops, w, h, fps):
    sizes = [len(v) for v in vops]
    mdat = video.box(b"mdat", *vops)
    with open(path, "wb") as f:
        f.write(video.FTYP + mdat + video.moov(
            w, h, fps, sizes, len(video.FTYP) + 8,
            video.config_headers(w, h, fps)))


def _event_levels():
    """Blocks whose AC levels hold every (last, run, level) of the intra
    table, signs alternating, and events past it (escapes 1, 2, 3): one
    event a block, a `last` event (1, 0, 1) after each non-last one."""
    events = [(last, run, lvl) for (last, run), e in video._INTRA_VLC.items()
              for lvl in range(1, len(e) + 1)]
    events += [(0, 0, 28), (0, 1, 12), (1, 0, 9), (0, 15, 1), (1, 21, 1),
               (0, 3, 6), (1, 2, 3), (0, 40, 5), (1, 62, 300), (0, 0, 2047)]
    blocks = []
    for k, (last, run, lvl) in enumerate(events):
        zz = np.zeros(64, np.int64)
        zz[0] = 100 + k % 50  # DC
        zz[1 + run] = lvl if k % 2 else -lvl
        if not last:
            zz[2 + run] = 1
        blocks.append(zz)
    while len(blocks) % 6:
        blocks.append(np.r_[120, np.zeros(63, np.int64)])
    lv = np.zeros((len(blocks), 64), np.int64)
    lv[:, video._ZIGZAG] = np.stack(blocks)
    n_mb = len(blocks) // 6
    mbx = 4
    mby = -(-n_mb // mbx)
    pad = np.zeros((mby * mbx - n_mb, 6, 64), np.int64)
    pad[:, :, 0] = 110
    return np.concatenate([lv.reshape(n_mb, 6, 64), pad]), (mby, mbx)


def test_intra_vlc_table_decodes_as_escape_codes(tmp_path, monkeypatch):
    """Every VLC of the intra table (and escapes 1 and 2) through ffmpeg's
    decoder gives the frame that the same levels give as escape-3 codes
    (fixed-length, no table): a wrong code would desynchronise it."""
    levels, (mby, mbx) = _event_levels()
    w, h = 16 * mbx, 16 * mby
    table = video.encode_vop(levels, (mby, mbx), 0, 30)
    monkeypatch.setattr(video, "_VLC_LEN", np.zeros_like(video._VLC_LEN))
    escaped = video.encode_vop(levels, (mby, mbx), 0, 30)
    assert len(escaped) > len(table)
    _mp4_of_vops(tmp_path / "t.mp4", [table], w, h, 30)
    _mp4_of_vops(tmp_path / "e.mp4", [escaped], w, h, 30)
    (ft,), _ = _read(tmp_path / "t.mp4")
    (fe,), _ = _read(tmp_path / "e.mp4")
    np.testing.assert_array_equal(ft, fe)


def _boxes(data, start=0, end=None):
    end = len(data) if end is None else end
    out, pos = {}, start
    while pos < end:
        size, kind = struct.unpack(">I4s", data[pos:pos + 8])
        out.setdefault(kind.decode(), []).append((pos + 8, pos + size))
        pos += size
    assert pos == end
    return out


def test_mp4_boxes(tmp_path):
    n, fps, w, h = 4, 12, 51, 31  # written as 50x30
    with video.Mp4Writer(str(tmp_path / "v.mp4"), fps, (w, h)) as wr:
        for i in range(n):
            assert wr.write(_render_like(i, h, w))
        assert not wr.write(_render_like(9, h + 2, w))  # another size
    data = (tmp_path / "v.mp4").read_bytes()
    top = _boxes(data)
    assert list(top) == ["ftyp", "mdat", "moov"]
    moov = _boxes(data, *top["moov"][0])
    trak = _boxes(data, *moov["trak"][0])
    s, e = trak["tkhd"][0]
    assert struct.unpack(">II", data[e - 8:e]) == (w - 1 << 16, h - 1 << 16)
    mdia = _boxes(data, *trak["mdia"][0])
    s, e = mdia["mdhd"][0]
    assert struct.unpack(">II", data[s + 12:s + 20]) == (fps, n)
    assert data[mdia["hdlr"][0][0] + 8:][:4] == b"vide"
    stbl = _boxes(data, *_boxes(data, *mdia["minf"][0])["stbl"][0])
    assert set(stbl) == {"stsd", "stts", "stss", "stsc", "stsz", "stco"}
    s, _ = stbl["stsz"][0]
    count = struct.unpack(">I", data[s + 8:s + 12])[0]
    sizes = struct.unpack(f">{count}I", data[s + 12:s + 12 + 4 * count])
    (offset,) = struct.unpack(">I", data[stbl["stco"][0][0] + 8:][:4])
    assert count == n and offset == top["mdat"][0][0]
    assert struct.unpack(">II", data[stbl["stts"][0][0] + 8:][:8]) == (n, 1)
    stss = stbl["stss"][0][0]
    assert struct.unpack(f">{n + 1}I", data[stss + 4:stss + 8 + 4 * n]) == \
        (n, *range(1, n + 1))
    pos = offset
    for size in sizes:
        assert data[pos:pos + 4] == b"\x00\x00\x01\xb6"
        assert data[pos + 4] >> 6 == 0  # an I-VOP
        pos += size
    assert pos == top["mdat"][0][1]
    stsd = data[slice(*stbl["stsd"][0])]
    i = stsd.index(b"mp4v")
    assert struct.unpack(">HH", stsd[i + 28:i + 32]) == (w - 1, h - 1)
    j = stsd.index(b"esds")
    assert b"\x20\x11" in stsd[j:j + 40]
    cfg = video.config_headers(w - 1, h - 1, fps)
    assert cfg[:4] == b"\x00\x00\x01\xb0" and cfg in stsd


def test_read_frame_is_cv2_imread(tmp_path):
    rng = np.random.RandomState(3)
    for c in (1, 2, 3, 4):
        img = (rng.rand(9, 11, c) * 255).astype(np.uint8)
        path = str(tmp_path / f"f{c}.png")
        images.write_png(path, img if c > 1 else img[..., 0])
        np.testing.assert_array_equal(pvideo.read_frame(path),
                                      cv2.imread(path)[..., ::-1])
