"""`cli/export_lpips_weights.py` of the port against the JAX package's,
driven by a seeded stand-in for the `lpips` package
(`tools/lpips_standin.py`: `LPIPS(net="vgg")` with the package's module
structure): both CLIs write the same `.npz`, key for key and bit for bit;
each package's `LPIPS` loader reads it to the same distance, at the eval
tests' tolerance (1e-5 relative); without the package both raise the same
ImportError."""

import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from consistentnerf_tpu.cli import export_lpips_weights as jexport
from consistentnerf_tpu.train import lpips as jlpips
from consistentnerf_tpu_torch.cli import export_lpips_weights as export
from consistentnerf_tpu_torch.train import lpips
from torch_port_shared import _one_torch_thread  # noqa: F401

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tools"))
import lpips_standin  # noqa: E402

TOL = 1e-5


@pytest.fixture
def exports(tmp_path, monkeypatch, capsys):
    """Both CLIs' `.npz` from the stand-in, and what each printed."""
    monkeypatch.setitem(sys.modules, "lpips", lpips_standin.module(seed=0))
    out = {}
    for name, cli in (("jax", jexport), ("port", export)):
        path = str(tmp_path / f"{name}.npz")
        cli.main([path])
        out[name] = (path, capsys.readouterr().out)
    return out


def test_both_clis_write_the_same_npz(exports):
    (jpath, jsaid), (path, said) = exports["jax"], exports["port"]
    assert said == f"wrote {path}\n" and jsaid == f"wrote {jpath}\n"
    with np.load(jpath) as want, np.load(path) as got:
        assert list(got.keys()) == list(want.keys())
        assert len(got.keys()) == 2 * 13 + 5
        for k in want.keys():
            assert got[k].dtype == want[k].dtype, k
            assert got[k].shape == want[k].shape, k
            assert got[k].tobytes() == want[k].tobytes(), k
        assert got["conv0_0_w"].shape == (3, 3, 3, 64)
        assert got["lin4"].shape == (512,)


def test_both_loaders_read_the_export_to_one_distance(exports):
    path, _ = exports["port"]
    rng = np.random.RandomState(0)
    gt = rng.rand(2, 40, 48, 3).astype(np.float32)
    pred = np.clip(gt + 0.1 * rng.randn(*gt.shape), 0, 1).astype(np.float32)
    fn = lpips.LPIPS(path, device="cpu")
    assert fn.is_calibrated
    got = fn(torch.from_numpy(pred), torch.from_numpy(gt)).numpy()
    want = np.asarray(jlpips.LPIPS(path)(jnp.asarray(pred), jnp.asarray(gt)))
    assert got.shape == want.shape == (2,)
    np.testing.assert_allclose(got, want, rtol=TOL)
    # The stand-in's own weights, read by the port's loader as stored.
    net = sys.modules["lpips"].LPIPS(net="vgg")
    conv = net.net.slice3[1]
    np.testing.assert_array_equal(fn.params["convs"][2][0]["w"].numpy(),
                                  conv.weight.detach().numpy())


def test_without_the_package_both_raise_the_same_import_error(
        tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "lpips", None)
    errors = []
    for cli in (jexport, export):
        with pytest.raises(ImportError) as info:
            cli.main([str(tmp_path / "x.npz")])
        errors.append((type(info.value), str(info.value), info.value.name))
    assert errors[0] == errors[1]
    assert errors[0][2] == "lpips"
    assert not os.listdir(tmp_path)
