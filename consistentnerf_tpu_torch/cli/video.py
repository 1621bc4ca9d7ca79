"""Video CLI: stitch rendered frames into an MP4.

    python -m consistentnerf_tpu_torch.cli.video FRAMES_DIR [--out F] [--fps 30]
    cnerf-torch-video FRAMES_DIR

The port of `consistentnerf_tpu/cli/video.py` (the reference's
`alky/video_generation.py`, `RegNeRF/video_generation.py`): the
`color_*.png` frames of FRAMES_DIR in name order, each beside its
`depth_*.png` when the first frame has one, at `--fps`, into
`FRAMES_DIR/video.mp4` (or `--out`). Frames are read as `cv2.imread`
reads them (grey becomes 3 channels, alpha is dropped) and written by
`data/video.py::Mp4Writer`, an `mp4v` (MPEG-4 Part 2) writer of the
port's own, with `cv2.VideoWriter`'s rules: an odd width or height is cut
to even, and a frame whose size differs from the first (a later frame
without its depth file) is dropped with a warning, as OpenCV drops it.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

import numpy as np

from consistentnerf_tpu_torch.data import images
from consistentnerf_tpu_torch.data.video import Mp4Writer


def read_frame(path: str) -> np.ndarray:
    """An image as uint8 [H, W, 3] RGB, as cv2.imread reads it (grey to
    three channels, alpha dropped)."""
    img = images.imread(path)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[2] in (1, 2):
        img = img[..., :1]
    return np.ascontiguousarray(np.broadcast_to(
        img[..., :3], img.shape[:2] + (3,)))


def main(argv=None):
    p = argparse.ArgumentParser(description="Stitch rendered frames to mp4")
    p.add_argument("frames_dir", help="dir with color_###.png / depth_###.png")
    p.add_argument("--out", default=None)
    p.add_argument("--fps", type=int, default=30)
    args = p.parse_args(argv)

    colors = sorted(glob.glob(os.path.join(args.frames_dir, "color_*.png")))
    if not colors:
        raise SystemExit(f"no color_*.png frames in {args.frames_dir}")
    out_path = args.out or os.path.join(args.frames_dir, "video.mp4")

    h, w = read_frame(colors[0]).shape[:2]
    side_by_side = os.path.isfile(colors[0].replace("color_", "depth_"))
    width = w * 2 if side_by_side else w

    with Mp4Writer(out_path, args.fps, (width, h)) as writer:
        for c in colors:
            img = read_frame(c)
            d = c.replace("color_", "depth_")
            if side_by_side and os.path.isfile(d):
                img = np.concatenate([img, read_frame(d)], axis=1)
            if not writer.write(img):
                print(f"warning: {c} is {img.shape[1]}x{img.shape[0]}, not "
                      f"the video's {writer.width}x{writer.height}: frame "
                      "dropped", file=sys.stderr)
    print("wrote", out_path, f"({len(colors)} frames)")
    return out_path


if __name__ == "__main__":
    main()
