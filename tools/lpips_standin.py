"""A seeded stand-in for the `lpips` pip package, for the
`export_lpips_weights` CLIs where the package and its downloaded weights
are missing:

    sys.modules["lpips"] = lpips_standin.module(seed=0)

`lpips.LPIPS(net="vgg")` then has the package's module structure:
`.net.slice1` .. `.net.slice5` hold torchvision's VGG16 `features`
layers 0-3, 4-8, 9-15, 16-22 and 23-29 (3x3 convolutions with biases,
ReLUs, 2x2 max pools), and `.lins[b].model[-1]` is head b's 1x1
convolution without a bias, after a dropout. The weights are seeded
draws of the package's shapes (convs N(0, 2 / (9 Cin)), biases
N(0, 0.01^2), heads |N(0, 0.1^2)|), not the calibrated ones: the
exports and distances of both packages agree with each other, not with
published LPIPS values. Used by tests/test_torch_port_export_lpips.py
and by chip_smoke.py.
"""

from __future__ import annotations

import types

# VGG16 (out_channels, convs) per block, as torchvision builds it.
VGG16_BLOCKS = ((64, 2), (128, 2), (256, 3), (512, 3), (512, 3))
# lpips.pretrained_networks.vgg16: the slices of `features`.
SLICES = ((0, 4), (4, 9), (9, 16), (16, 23), (23, 30))


def module(seed: int = 0) -> types.ModuleType:
    """A module named `lpips` whose `LPIPS(net="vgg")` builds the stand-in
    from `seed` (every instance the same weights)."""
    import torch

    def features(gen):
        layers, c_in = [], 3
        for bi, (c_out, n_convs) in enumerate(VGG16_BLOCKS):
            if bi:
                layers.append(torch.nn.MaxPool2d(2, 2))
            for _ in range(n_convs):
                conv = torch.nn.Conv2d(c_in, c_out, 3, padding=1)
                with torch.no_grad():
                    conv.weight.copy_(torch.randn(
                        conv.weight.shape, generator=gen)
                        * (2.0 / (9 * c_in)) ** 0.5)
                    conv.bias.copy_(torch.randn(c_out, generator=gen) * 0.01)
                layers += [conv, torch.nn.ReLU()]
                c_in = c_out
        return layers

    class Vgg16(torch.nn.Module):
        def __init__(self, gen):
            super().__init__()
            layers = features(gen)
            for i, (lo, hi) in enumerate(SLICES):
                sl = torch.nn.Sequential()
                for x in range(lo, hi):
                    sl.add_module(str(x), layers[x])
                setattr(self, f"slice{i + 1}", sl)

    class NetLinLayer(torch.nn.Module):
        def __init__(self, c_in, gen):
            super().__init__()
            conv = torch.nn.Conv2d(c_in, 1, 1, bias=False)
            with torch.no_grad():
                conv.weight.copy_(torch.randn(conv.weight.shape,
                                              generator=gen).abs() * 0.1)
            self.model = torch.nn.Sequential(torch.nn.Dropout(), conv)

    class LPIPS(torch.nn.Module):
        def __init__(self, net: str = "alex", **_):
            super().__init__()
            if net != "vgg":
                raise ValueError(f"the stand-in builds net='vgg' only, got "
                                 f"{net!r}")
            gen = torch.Generator().manual_seed(seed)
            self.net = Vgg16(gen)
            self.lins = torch.nn.ModuleList(
                [NetLinLayer(c, gen) for c, _ in VGG16_BLOCKS])

    mod = types.ModuleType("lpips")
    mod.LPIPS = LPIPS
    return mod
