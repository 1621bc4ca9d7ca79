"""PFM (portable float map) files, the depth priors' format. Rows are
stored bottom-up, so the data is flipped vertically on read and write."""

from __future__ import annotations

import re

import numpy as np


def read_pfm(filename: str):
    """(data [H, W] or [H, W, 3] float32, scale) of a PFM file."""
    with open(filename, "rb") as f:
        header = f.readline().decode("utf-8").rstrip()
        if header == "PF":
            color = True
        elif header == "Pf":
            color = False
        else:
            raise ValueError(f"{filename}: not a PFM file")
        dim_match = re.match(r"^(\d+)\s(\d+)\s$", f.readline().decode("utf-8"))
        if not dim_match:
            raise ValueError(f"{filename}: malformed PFM header")
        width, height = map(int, dim_match.groups())
        scale = float(f.readline().rstrip())
        endian = "<" if scale < 0 else ">"
        data = np.fromfile(f, endian + "f")
    shape = (height, width, 3) if color else (height, width)
    return np.flipud(np.reshape(data, shape)), abs(scale)


def write_pfm(filename: str, image: np.ndarray, scale: float = 1.0):
    """Write a [H, W] or [H, W, 3] float32 PFM (little-endian)."""
    image = np.asarray(image, np.float32)
    if image.ndim == 3 and image.shape[2] == 3:
        color = True
    elif image.ndim == 2:
        color = False
    else:
        raise ValueError(f"Bad PFM shape {image.shape}")
    with open(filename, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{image.shape[1]} {image.shape[0]}\n".encode())
        f.write(f"{-abs(scale)}\n".encode())  # negative: little-endian
        np.flipud(image).astype("<f").tofile(f)
