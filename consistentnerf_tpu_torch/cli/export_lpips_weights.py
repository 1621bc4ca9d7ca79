"""Export the `lpips` package's VGG weights to the `.npz` that
`train/lpips.py::load_weights` reads:

    python -m consistentnerf_tpu_torch.cli.export_lpips_weights out.npz

then point `Config.lpips_weights_path` at the file. It needs the `lpips`
pip package and the weights it downloads (`lpips.LPIPS(net="vgg")`);
without the package it raises the ImportError of `import lpips`. The file
is the one the JAX package's `cli/export_lpips_weights.py` writes, so
either package reads either's export: `conv{b}_{i}_w` [3, 3, Cin, Cout]
(HWIO) and `conv{b}_{i}_b` [Cout] for the convolutions of VGG16 slice
b + 1, and `lin{b}` [C], the b-th linear head's 1x1 weights flattened.
"""

from __future__ import annotations

import argparse
from typing import Dict

import numpy as np

SLICES = ("slice1", "slice2", "slice3", "slice4", "slice5")


def lpips_vgg_arrays(net) -> Dict[str, np.ndarray]:
    """The arrays of an `lpips.LPIPS(net="vgg")` module: its VGG16
    wrapper's slice1..slice5 convolutions (torch OIHW -> HWIO) and the
    last layer of each linear head."""
    import torch

    out = {}
    for bi, name in enumerate(SLICES):
        convs = [layer for layer in getattr(net.net, name)
                 if isinstance(layer, torch.nn.Conv2d)]
        for ci, conv in enumerate(convs):
            out[f"conv{bi}_{ci}_w"] = (
                conv.weight.detach().numpy().transpose(2, 3, 1, 0))
            out[f"conv{bi}_{ci}_b"] = conv.bias.detach().numpy()
        out[f"lin{bi}"] = (
            net.lins[bi].model[-1].weight.detach().numpy().reshape(-1))
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("out", help="output .npz path")
    args = p.parse_args(argv)

    import lpips as lpips_pkg  # the pip package; it downloads the weights

    np.savez(args.out, **lpips_vgg_arrays(lpips_pkg.LPIPS(net="vgg")))
    print("wrote", args.out)


if __name__ == "__main__":
    main()
