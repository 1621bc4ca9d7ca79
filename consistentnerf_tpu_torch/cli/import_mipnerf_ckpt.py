"""Import a pretrained mip-NeRF flax checkpoint (RegNeRF's format) as a
train checkpoint of this package's mip backbone:

    python -m consistentnerf_tpu_torch.cli.import_mipnerf_ckpt \
        /path/to/checkpoint_250000 /tmp/exp --set backbone=mipnerf

The public mip-NeRF checkpoints carry an `MLP_0` with Dense_0..Dense_20
(per-level duplicated heads); RegNeRF's eval remaps them onto its
12-layer MipMLP before restoring (`RegNeRF/eval.py:100-118`): drop
Dense_9 and Dense_17, then Dense_18 -> Dense_9 (bottleneck),
Dense_19 -> Dense_10 (viewdir), Dense_20 -> Dense_11 (rgb). This CLI
applies the same remap (`remap_pretrained_mlp`), loads the layers
strictly into the configured `MipNeRF` (flax [in, out] kernels become
torch [out, in] weights) and writes them with a fresh optimizer to
`{out}/checkpoints/`, where the train, eval and render CLIs find them
when `out` is `{basedir}/{expname}`.

The checkpoint is a flax `msgpack` file (`flax.training.checkpoints` in
its file format; a directory means its newest `checkpoint_*` file).
This package reads it with its own decoder (`msgpack_unpackb`): maps,
arrays, strings, integers, floats, booleans, nil, bin, and flax's array
extensions (code 1, an ndarray as a packed (shape, dtype name, bytes);
code 3, a numpy scalar the same way). Anything else raises, as do orbax
checkpoint directories.
"""

from __future__ import annotations

import glob
import os
import re
import struct

import numpy as np

# flax.serialization's extension codes.
EXT_NDARRAY = 1
EXT_NPSCALAR = 3


class _Reader:
    def __init__(self, data: bytes):
        self.data = memoryview(data)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside an object")
        out = self.data[self.pos: self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]


def _ndarray(payload: bytes) -> np.ndarray:
    """flax's `_ndarray_from_bytes`: payload packs (shape, dtype, bytes)."""
    shape, dtype, buf = msgpack_unpackb(payload)
    return np.frombuffer(buf, np.dtype(dtype)).reshape(shape).copy()


def _value(r: _Reader):
    b = r.unpack("B")
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_value(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return r.take(b & 0x1F).decode("utf-8")
    simple = {0xC0: None, 0xC2: False, 0xC3: True}
    if b in simple:
        return simple[b]
    sized = {  # code -> (kind, length format)
        0xC4: ("bin", "B"), 0xC5: ("bin", "H"), 0xC6: ("bin", "I"),
        0xD9: ("str", "B"), 0xDA: ("str", "H"), 0xDB: ("str", "I"),
        0xDC: ("array", "H"), 0xDD: ("array", "I"),
        0xDE: ("map", "H"), 0xDF: ("map", "I"),
        0xC7: ("ext", "B"), 0xC8: ("ext", "H"), 0xC9: ("ext", "I"),
    }
    if b in sized:
        kind, fmt = sized[b]
        n = r.unpack(fmt)
        if kind == "bin":
            return r.take(n)
        if kind == "str":
            return r.take(n).decode("utf-8")
        if kind == "array":
            return [_value(r) for _ in range(n)]
        if kind == "map":
            return _map(r, n)
        return _ext(r.unpack("b"), r.take(n))
    if 0xD4 <= b <= 0xD8:  # fixext 1, 2, 4, 8, 16
        code = r.unpack("b")
        return _ext(code, r.take(1 << (b - 0xD4)))
    numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I",
               0xCF: "Q", 0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
    if b in numbers:
        return r.unpack(numbers[b])
    raise ValueError(f"msgpack type byte 0x{b:02x} at offset {r.pos - 1} "
                     "is not read")


def _map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _value(r)
        out[k] = _value(r)
    return out


def _ext(code: int, payload: bytes):
    if code == EXT_NDARRAY:
        return _ndarray(payload)
    if code == EXT_NPSCALAR:
        return _ndarray(payload)[()]
    raise ValueError(f"msgpack extension type {code} is not read (flax "
                     f"writes arrays as {EXT_NDARRAY} and numpy scalars "
                     f"as {EXT_NPSCALAR})")


def msgpack_unpackb(data: bytes):
    """Decode one msgpack object (flax's `msgpack_restore`)."""
    r = _Reader(data)
    out = _value(r)
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes after the msgpack "
                         "object")
    return out


def checkpoint_file(path: str) -> str:
    """The flax checkpoint file of `path`: the file itself, or a
    directory's newest `checkpoint_<step>` (flax's file naming)."""
    if os.path.isdir(path):
        if os.path.exists(os.path.join(path, "_CHECKPOINT_METADATA")):
            raise ValueError(f"{path} is an orbax checkpoint directory; "
                             "this importer reads flax msgpack files")
        found = [(int(m.group(1)), p) for p in glob.glob(
            os.path.join(path, "checkpoint_*"))
            if (m := re.search(r"checkpoint_(\d+)$", p))]
        if not found:
            raise FileNotFoundError(f"no flax checkpoint found at {path}")
        path = max(found)[1]
        if os.path.isdir(path):
            return checkpoint_file(path)
    if not os.path.isfile(path):
        raise FileNotFoundError(f"no flax checkpoint found at {path}")
    return path


def load_pretrained_state_dict(path: str) -> dict:
    """A flax checkpoint file (or a directory of them) -> its raw state
    dict (numpy leaves)."""
    with open(checkpoint_file(path), "rb") as f:
        return msgpack_unpackb(f.read())


def remap_pretrained_mlp(mlp: dict, net_depth: int = 8) -> dict:
    """The RegNeRF pretrained-layer remap (eval.py:100-118): mlp is
    {'Dense_i': {'kernel', 'bias'}} with i in 0..20 (pretrained) or
    already 0..net_depth+3 (passed through). Returns the layout of
    `MipMLP` (trunk 0..D-1, density D, bottleneck D+1, viewdir D+2, rgb
    D+3); the reference's 9/10/11 destinations are D+1/D+2/D+3."""
    n_target = net_depth + 4
    have = {k for k in mlp if k.startswith("Dense_")}
    if have == {f"Dense_{i}" for i in range(n_target)}:
        return dict(mlp)
    out = {k: v for k, v in mlp.items() if k.startswith("Dense_")}
    # The dropped density duplicate (9) and the second level's density
    # (17); bottleneck / viewdir / rgb sit at 18 / 19 / 20.
    for i in (9, 17):
        out.pop(f"Dense_{i}", None)
    for src, dst in ((18, net_depth + 1), (19, net_depth + 2),
                     (20, net_depth + 3)):
        if f"Dense_{src}" in out:
            out[f"Dense_{dst}"] = out.pop(f"Dense_{src}")
    missing = {f"Dense_{i}" for i in range(n_target)} - set(out)
    if missing:
        raise KeyError(f"pretrained checkpoint is missing layers "
                       f"{sorted(missing)} after the eval.py remap; found "
                       f"{sorted(have)}")
    # Layers past the target (the pretrained Dense_12..16) are ignored,
    # as flax's from_state_dict ignores them.
    return {f"Dense_{i}": out[f"Dense_{i}"] for i in range(n_target)}


def pretrained_to_params(state_dict: dict, net_depth: int = 8):
    """{'optimizer': {'target': {'params': {'MLP_0': ...}}}} -> (the mip
    param tree {'params': {'MipMLP_0': ...}} with numpy leaves, step)."""
    opt = state_dict.get("optimizer", state_dict)
    target = opt.get("target", opt)
    params = target.get("params", target)
    mlp_key = "MLP_0" if "MLP_0" in params else "MipMLP_0"
    mlp = remap_pretrained_mlp(params[mlp_key], net_depth)
    tree = {"params": {"MipMLP_0": {
        k: {"kernel": np.asarray(v["kernel"], np.float32),
            "bias": np.asarray(v["bias"], np.float32)}
        for k, v in mlp.items()}}}
    step = 0
    st = opt.get("state", {})
    if isinstance(st, dict) and "step" in st:
        step = int(np.asarray(st["step"]))
    return tree, step


def import_checkpoint(path: str, cfg, device="cuda"):
    """A pretrained flax checkpoint -> a `TrainState` of `cfg` (the mip
    backbone) at its step, the optimizer fresh, on `device` (`cuda`
    unless the caller asks for the CPU). The layers load strictly:
    a missing, extra or misshapen layer raises."""
    from consistentnerf_tpu_torch import interop
    from consistentnerf_tpu_torch.models.factory import make_model
    from consistentnerf_tpu_torch.train.state import create_train_state

    if cfg.backbone != "mipnerf":
        raise ValueError("the importer targets backbone=mipnerf (use --set "
                         "backbone=mipnerf)")
    tree, step = pretrained_to_params(load_pretrained_state_dict(path),
                                      cfg.netdepth)
    model = make_model(cfg, device)
    model.load_state_dict(interop.mip_params_from_jax(tree))
    state = create_train_state(cfg, model)
    state.step = step
    return state


def main(argv=None):
    from consistentnerf_tpu_torch.cli import common
    from consistentnerf_tpu_torch.train.checkpoints import CheckpointManager

    p = common.make_parser("Import a pretrained mip-NeRF flax checkpoint")
    p.add_argument("ckpt", help="flax checkpoint file or directory")
    p.add_argument("out", help="experiment dir to write the checkpoint into")
    args = p.parse_args(argv)
    cfg = common.resolve_config(args)
    if cfg.backbone != "mipnerf":
        raise SystemExit("importer targets backbone=mipnerf (use --set "
                         "backbone=mipnerf)")
    state = import_checkpoint(args.ckpt, cfg, args.device)
    path = CheckpointManager(os.path.join(args.out, "checkpoints")).save(
        max(state.step, 1), state)
    print(f"imported pretrained mip-NeRF checkpoint (step {state.step}) "
          f"into {path}")
    return path


if __name__ == "__main__":
    main()
