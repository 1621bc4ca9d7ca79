"""The port stands alone: importing every module of consistentnerf_tpu_torch
loads no jax, flax, optax or orbax and nothing of consistentnerf_tpu, and
chip_smoke.py refuses to report without a card or without the repo. Each
check runs in a subprocess: this test process imports jax already."""

import os
import shutil
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import consistentnerf_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
banned = ("jax", "jaxlib", "flax", "optax", "orbax", "consistentnerf_tpu")
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in banned)
print(len(names), "modules;", "banned:", bad)
assert not bad, bad
for need in ("ops.fused_mlp_v2", "cli.render", "interop", "train.render",
             "ops.fused_onepass", "cli.train", "train.loop", "train.step",
             "train.state", "train.losses", "train.checkpoints",
             "train.image_metrics", "data.pipeline", "consistency.masks",
             "consistency.monodepth", "ops.fused_mip", "ops.fused_train",
             "models.mipnerf", "core.mip", "core.spacing",
             "data.random_poses", "ops.fused_mlp_train",
             "consistency.reproject", "data.loaders"):
    assert "consistentnerf_tpu_torch." + need in names, need
"""


def _run(args, cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    proc = _run(["-c", _IMPORT_ALL], REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "banned: []" in proc.stdout


def test_chip_smoke_imports_no_jax():
    src = open(os.path.join(REPO, "chip_smoke.py")).read()
    for banned in ("import jax", "from jax", "flax", "optax", "orbax",
                   "consistentnerf_tpu.", "consistentnerf_tpu "):
        assert banned not in src, banned


def test_chip_smoke_fails_without_a_card_and_alone(tmp_path):
    # Here there is no CUDA device: it must fail before any result line.
    proc = _run(["chip_smoke.py"], REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and '"kernels"' not in proc.stdout
    # In a directory holding only the script it must fail too.
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run(["chip_smoke.py"], str(tmp_path))
    assert proc.returncode != 0 and '"ok"' not in proc.stdout


def test_train_dispatch_raises_rather_than_falls_back():
    """ss_loss is not ported: the steps raise, naming the ROADMAP item,
    instead of running another step (the one-pass gate is the JAX
    predicate, which accepts it). softLpmask with use_fused_train goes to
    the two-call fused step, as in the JAX package, for every
    fused_kernel, the v1 kinds included."""
    import pytest

    from consistentnerf_tpu_torch import configs
    from consistentnerf_tpu_torch.ops import fused_onepass, fused_train
    from consistentnerf_tpu_torch.train import loop

    base = configs.Config(netdepth=2, netwidth=32, N_samples=8,
                          N_importance=8, use_fused_train=True,
                          use_onepass_train=True)
    assert fused_onepass.onepass_supported(base)
    ss = base.replace(ss_loss=True)
    assert fused_onepass.onepass_supported(ss)
    with pytest.raises(NotImplementedError, match="consistency"):
        loop.select_train_step(ss, None)
    with pytest.raises(NotImplementedError, match="consistency"):
        loop.select_train_step(ss.replace(use_fused_train=False), None)
    with pytest.raises(NotImplementedError, match="consistency"):
        loop.select_train_step(ss.replace(softLpmask=True), None)
    soft = base.replace(softLpmask=True)
    assert not fused_onepass.onepass_supported(soft)
    step = loop.select_train_step(soft, None)
    assert step.__qualname__.startswith(
        fused_train.build_fused_vanilla_train_step.__name__)
    for kind in ("v1", "hybrid"):
        step = loop.select_train_step(soft.replace(fused_kernel=kind), None)
        assert step.__qualname__.startswith(
            fused_train.build_fused_vanilla_train_step.__name__)
    with pytest.raises(ValueError, match="per-ray losses"):
        fused_onepass.build_onepass_vanilla_train_step(soft)
    assert loop.select_train_step(soft.replace(use_fused_train=False),
                                  None) is not None
