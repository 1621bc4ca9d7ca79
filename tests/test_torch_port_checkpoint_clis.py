"""The checkpoint CLIs against their JAX twins, on files the test writes:
`cli/import_torch_ckpt.py` on a reference `.tar` (written by the JAX
package's exporter in the reference layout), `cli/export_torch_ckpt.py`
on a port checkpoint (read back by the JAX importer), and
`cli/import_mipnerf_ckpt.py` on a flax checkpoint written by
`flax.training.checkpoints` in its msgpack file format (the format of
the public mip-NeRF checkpoints), with the port's own msgpack decoder
held to flax's. The restored weights equal the JAX package's bit for
bit; the renders from them agree with the JAX model's within 1e-5; the
train CLI resumes from an imported checkpoint and the render CLI
restores one.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consistentnerf_tpu.cli import export_torch_ckpt as jexport
from consistentnerf_tpu.cli import import_mipnerf_ckpt as jmip
from consistentnerf_tpu.cli import import_torch_ckpt as jimport
from consistentnerf_tpu.configs import Config as JaxConfig
from consistentnerf_tpu.core.rays import Rays as JaxRays
from consistentnerf_tpu.models.factory import make_model as jax_make_model
from consistentnerf_tpu_torch import configs, interop
from consistentnerf_tpu_torch.cli import export_torch_ckpt, import_mipnerf_ckpt
from consistentnerf_tpu_torch.cli import import_torch_ckpt
from consistentnerf_tpu_torch.cli import render as render_cli
from consistentnerf_tpu_torch.cli import train as train_cli
from consistentnerf_tpu_torch.core.rays import Rays
from consistentnerf_tpu_torch.models.factory import make_model
from consistentnerf_tpu_torch.train.checkpoints import CheckpointManager
from consistentnerf_tpu_torch.train.state import create_train_state
from torch_port_shared import _one_torch_thread  # noqa: F401

VANILLA = dict(backbone="vanilla", netdepth=4, netwidth=32, N_samples=8,
               N_importance=8, multires=4, multires_views=2)
MIP = dict(backbone="mipnerf", netdepth=4, netwidth=32, mip_num_samples=8,
           max_deg_point=4, disable_normals=True)
RTOL = dict(rtol=1e-5, atol=1e-6)
SCENE_SETS = ["dataset_type=synthetic", "synthetic_hw=16",
              "synthetic_views=3", "synthetic_n_test=1", "N_rand=32",
              "n_patches=0", "i_print=1", "use_tensorboard=false"]


def _args(tmp_path, kw, expname, extra=()):
    sets = [f"{k}={str(v).lower() if isinstance(v, bool) else v}"
            for k, v in kw.items()] + SCENE_SETS + [
        f"basedir={tmp_path}", f"expname={expname}", *extra]
    return ["--device", "cpu"] + [x for s in sets for x in ("--set", s)]


def _rays(n=16, seed=0):
    rng = np.random.RandomState(seed)
    o = rng.uniform(-0.2, 0.2, (n, 3)).astype(np.float32)
    d = rng.normal(0, 1, (n, 3)).astype(np.float32) * 0.2
    d[:, 2] = -1.0
    v = d / np.linalg.norm(d, axis=-1, keepdims=True)
    ones = np.ones((n, 1), np.float32)
    f = dict(origins=o, directions=d, viewdirs=v, radii=ones * 1e-3,
             lossmult=ones, near=ones * 2.0, far=ones * 6.0)
    return (JaxRays(**{k: jnp.asarray(x) for k, x in f.items()}),
            Rays(**{k: torch.tensor(x) for k, x in f.items()}))


def _jax_params(kw):
    model = jax_make_model(JaxConfig(use_tensorboard=False, **kw))
    jrays, _ = _rays(4)
    return model, model.init(jax.random.PRNGKey(3), None, jrays)


def _assert_same_sd(got, want):
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k].cpu(), want[k].reshape(got[k].shape)), k


def test_import_torch_ckpt_matches_jax(tmp_path, capsys):
    """A reference `.tar` at step 120 -> a port train checkpoint at step
    120 with a fresh optimizer: the JAX importer's weights bit for bit,
    the JAX model's render; cli/train.py resumes from it and
    cli/render.py restores it."""
    jmodel, params = _jax_params(VANILLA)
    tar = str(tmp_path / "000120.tar")
    jexport.export_checkpoint(params, 120, tar, VANILLA["netdepth"])
    path = import_torch_ckpt.main([tar] + _args(tmp_path, VANILLA, "imp"))
    assert path.endswith("step_00000120.pt")
    ckpt = torch.load(path, weights_only=True)
    assert ckpt["step"] == 120 and ckpt["optimizer"]["state"] == {}
    cfg = configs.Config(**VANILLA)
    model = make_model(cfg, "cpu")
    assert CheckpointManager(os.path.dirname(path)).restore_for_eval(
        model) == 120
    want_params, want_step = jimport.import_checkpoint(tar, 4)
    assert want_step == 120
    _assert_same_sd(model.state_dict(), interop.params_from_jax(want_params))
    jrays, rays = _rays()
    want = jax.jit(jmodel.apply)(params, None, jrays)
    with torch.no_grad():
        got = model(rays)
    for k in ("rgb", "depth", "acc", "rgb0"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   err_msg=k, **RTOL)
    capsys.readouterr()
    res = train_cli.main(_args(tmp_path, VANILLA, "imp")
                         + ["--num-steps", "121"])
    assert "resumed from step 120" in capsys.readouterr().out
    assert res.state.step == 121
    out = render_cli.main(_args(tmp_path, VANILLA, "imp", [
        "checkpoint_every=1000"]) + ["--render-test", "--step", "120",
                                      "--out", str(tmp_path / "r")])
    assert "step_00000120.pt (step 120)" in capsys.readouterr().out
    assert sorted(os.listdir(out)) == ["color_000.png", "depth_000.png"]


def test_export_torch_ckpt_read_back_by_jax(tmp_path):
    """A port checkpoint -> the reference `.tar`: the keys and tensors the
    JAX exporter writes for the same weights, read back by the JAX
    importer into a model that renders as the port's, and by the port's
    importer bit for bit."""
    cfg = configs.Config(**VANILLA, basedir=str(tmp_path), expname="exp")
    with pytest.raises(SystemExit, match="no checkpoint"):
        export_torch_ckpt.export_checkpoint(cfg, str(tmp_path / "x.tar"))
    state = create_train_state(cfg, make_model(cfg, "cpu"))
    CheckpointManager(str(tmp_path / "exp" / "checkpoints")).save(7, state)
    tar = str(tmp_path / "out.tar")
    assert export_torch_ckpt.main([tar] + _args(tmp_path, VANILLA,
                                                "exp")) == 7
    got = torch.load(tar, weights_only=True)
    params, step = jimport.import_checkpoint(tar, 4)
    assert step == 7
    want_tar = str(tmp_path / "jax.tar")
    jexport.export_checkpoint(params, 7, want_tar, 4)
    want = torch.load(want_tar, weights_only=False)
    assert got.keys() == want.keys()
    assert got["optimizer_state_dict"] == want["optimizer_state_dict"]
    for key in ("network_fn_state_dict", "network_fine_state_dict"):
        assert got[key].keys() == want[key].keys()
        for k, v in got[key].items():
            assert v.dtype == torch.float32
            assert torch.equal(v, want[key][k]), (key, k)
    back, step = interop.load_reference_tar(tar)
    assert step == 7
    _assert_same_sd(state.model.state_dict(), back)
    jmodel = jax_make_model(JaxConfig(use_tensorboard=False, **VANILLA))
    jrays, rays = _rays(seed=1)
    want_out = jax.jit(jmodel.apply)(
        jax.tree_util.tree_map(jnp.asarray, params), None, jrays)
    with torch.no_grad():
        out = state.model(rays)
    for k in ("rgb", "depth", "rgb0"):
        np.testing.assert_allclose(out[k].numpy(), np.asarray(want_out[k]),
                                   err_msg=k, **RTOL)


def _pretrained(params, depth):
    """A Google-style pretrained state dict: the Dense_i of `params`
    scattered into the 21-layer layout (bottleneck / viewdir / rgb at
    18 / 19 / 20, junk at the dropped and ignored slots), as
    tests/test_mipnerf_ckpt_import.py builds it."""
    ours = params["params"]["MipMLP_0"]
    mlp = {f"Dense_{i}": {k: np.asarray(v) for k, v in
                          ours[f"Dense_{i}"].items()}
           for i in range(depth + 1)}
    for i in (9, 17, 12, 13):
        if f"Dense_{i}" not in mlp or i in (9, 17):
            mlp[f"Dense_{i}"] = {"kernel": np.ones((2, 2), np.float32),
                                 "bias": np.zeros((2,), np.float32)}
    for src, dst in ((18, depth + 1), (19, depth + 2), (20, depth + 3)):
        mlp[f"Dense_{src}"] = {k: np.asarray(v) for k, v in
                               ours[f"Dense_{dst}"].items()}
    return {"optimizer": {"target": {"params": {"MLP_0": mlp}},
                          "state": {"step": np.int32(250000)}},
            "optimizerd": {"junk": np.zeros(1)}}


@pytest.fixture
def flax_msgpack_files():
    """flax.training.checkpoints writing its msgpack file format (the
    public checkpoints'; this flax defaults to orbax directories)."""
    import flax

    was = flax.config.flax_use_orbax_checkpointing
    flax.config.update("flax_use_orbax_checkpointing", False)
    try:
        yield
    finally:
        flax.config.update("flax_use_orbax_checkpointing", was)


def test_import_mipnerf_ckpt_matches_jax(tmp_path, capsys,
                                         flax_msgpack_files):
    """A flax checkpoint file of the pretrained layout -> a port mip
    checkpoint: the JAX importer's remapped weights bit for bit and
    step, the JAX model's render; the render CLI restores the imported
    experiment."""
    from flax.training import checkpoints as flax_ckpt

    jmodel, params = _jax_params(MIP)
    ckpt_dir = str(tmp_path / "pretrained")
    os.makedirs(ckpt_dir)
    flax_ckpt.save_checkpoint(ckpt_dir, _pretrained(params, 4),
                              step=250000, prefix="checkpoint_")
    file = os.path.join(ckpt_dir, "checkpoint_250000")
    assert os.path.isfile(file)
    exp = tmp_path / "mip"
    path = import_mipnerf_ckpt.main([file, str(exp)]
                                    + _args(tmp_path, MIP, "mip"))
    assert path.endswith("step_00250000.pt")
    tree, step = jmip.pretrained_to_params(
        jmip.load_pretrained_state_dict(file), 4)
    assert step == 250000
    cfg = configs.Config(**MIP)
    model = make_model(cfg, "cpu")
    CheckpointManager(str(exp / "checkpoints")).restore_for_eval(model)
    _assert_same_sd(model.state_dict(), interop.mip_params_from_jax(tree))
    # A directory names its newest checkpoint file.
    state = import_mipnerf_ckpt.import_checkpoint(ckpt_dir, cfg, "cpu")
    assert state.step == 250000
    _assert_same_sd(state.model.state_dict(), model.state_dict())
    jrays, rays = _rays(seed=2)
    want = jax.jit(jmodel.apply)(params, None, jrays)
    with torch.no_grad():
        got = model(rays)
    for lvl in range(2):
        for k in ("rgb", "distance_mean"):
            np.testing.assert_allclose(got[lvl][k].numpy(),
                                       np.asarray(want[lvl][k]),
                                       err_msg=f"{lvl} {k}", **RTOL)
    capsys.readouterr()
    out = render_cli.main(_args(tmp_path, MIP, "mip")
                          + ["--render-test", "--out", str(tmp_path / "r")])
    assert "step_00250000.pt (step 250000)" in capsys.readouterr().out
    assert sorted(os.listdir(out)) == ["color_000.png", "depth_000.png"]
    # A .tar in a mip experiment is a vanilla network: refused by name.
    for p in (exp / "checkpoints").iterdir():
        p.unlink()
    (exp / "000100.tar").write_bytes(b"")
    with pytest.raises(ValueError, match="import_mipnerf_ckpt"):
        render_cli.main(_args(tmp_path, MIP, "mip") + ["--render-test"])


def test_msgpack_decoder_matches_flax(tmp_path):
    """The port's decoder against flax's own `msgpack_restore`, on a tree
    of every type it reads (each integer and string width, floats, bin,
    nil, booleans, nested maps and lists, arrays of several dtypes, numpy
    scalars); other extensions, trailing bytes and orbax directories
    raise."""
    from flax import serialization

    rng = np.random.RandomState(0)
    tree = {
        "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2**32, 2**63 - 1,
                 -1, -32, -33, -128, -129, -32768, -32769, -2**31 - 1,
                 -2**63],
        "floats": [0.5, -1e300, 1.0e-3],
        "strs": ["", "a" * 31, "b" * 32, "c" * 300, "d" * 70000, "ü"],
        "bin": b"\x00\x01" * 200,
        "flags": [True, False, None],
        "nested": {"list": [[1, 2], {"x": 3}], "empty": {}},
        "f32": rng.normal(size=(3, 4)).astype(np.float32),
        "f64": rng.normal(size=(5,)),
        "i8": np.arange(-4, 4, dtype=np.int8).reshape(2, 4),
        "u16": np.arange(7, dtype=np.uint16),
        "empty": np.zeros((0, 3), np.float32),
        "scalar": np.int32(250000),
        "f16": np.float16(1.5),
        "many": {f"k{i}": i for i in range(20)},
        "long": list(range(20)),
    }
    data = serialization.msgpack_serialize(tree)
    got = import_mipnerf_ckpt.msgpack_unpackb(data)
    want = serialization.msgpack_restore(data)

    def same(a, b, where):
        if isinstance(b, dict):
            assert isinstance(a, dict) and a.keys() == b.keys(), where
            for k in b:
                same(a[k], b[k], f"{where}/{k}")
        elif isinstance(b, (list, tuple)):
            assert isinstance(a, list) and len(a) == len(b), where
            for i, (x, y) in enumerate(zip(a, b)):
                same(x, y, f"{where}[{i}]")
        elif isinstance(b, (np.ndarray, np.generic)):
            assert type(a) is type(b) and a.dtype == b.dtype, where
            np.testing.assert_array_equal(a, b, err_msg=where)
        else:
            assert type(a) is type(b) and a == b, where

    same(got, want, "")
    data = serialization.msgpack_serialize({"w": np.zeros(3, np.float32)})
    with pytest.raises(ValueError, match="extension type 2"):
        import_mipnerf_ckpt.msgpack_unpackb(
            serialization.msgpack_serialize({"c": 1 + 2j}))
    with pytest.raises(ValueError, match="after the msgpack object"):
        import_mipnerf_ckpt.msgpack_unpackb(data + b"\x00")
    orbax = tmp_path / "checkpoint_5"
    orbax.mkdir()
    (orbax / "_CHECKPOINT_METADATA").write_text("{}")
    with pytest.raises(ValueError, match="orbax"):
        import_mipnerf_ckpt.load_pretrained_state_dict(str(orbax))
