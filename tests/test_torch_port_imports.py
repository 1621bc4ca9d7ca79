"""The port stands alone: importing every module of consistentnerf_tpu_torch
loads no jax, flax, optax, orbax or msgpack, nothing of consistentnerf_tpu
and no imaging package (imageio, cv2, PIL, matplotlib), and
chip_smoke.py refuses to report without a card or without the repo. Each
check runs in a subprocess: this test process imports jax already."""

import os
import shutil
import subprocess
import sys
from torch_port_shared import _one_torch_thread  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
import consistentnerf_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
# The card's machine has no jax and no imaging package: the port imports
# none of them (imageio, PIL and matplotlib only inside the functions
# that need them).
banned = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack",
          "consistentnerf_tpu", "imageio", "cv2", "PIL", "matplotlib")
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
             "consistency.reproject", "data.loaders", "data.images",
             "data.pfm", "data.pairs", "data.poses", "data.llff",
             "data.blender", "data.dtu", "train.lpips", "train.evaluation",
             "train.vis", "cli.eval", "configs.legacy", "configs.scenes",
             "consistency.online", "cli.export_configs", "models.mvs",
             "train.mvs", "train.bootstrap", "cli.train_mvs",
             "cli.export_depth_priors", "cli.make_masks",
             "cli.import_torch_ckpt", "cli.export_torch_ckpt",
             "cli.import_mipnerf_ckpt", "parallel.mesh",
             "parallel.distributed_render", "cli.metrics", "cli.jobs",
             "data.multicam", "data.jpeg", "data.video", "cli.video",
             "cli.export_lpips_weights"):
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


def test_image_and_video_paths_import_no_imaging_package():
    """The paths that read and write images and videos (imread's PNG and
    JPEG decoders, the LLFF loader, the MP4 writer and the video CLI)
    name no imaging package anywhere, lazily either."""
    for rel in ("data/images.py", "data/jpeg.py", "data/video.py",
                "data/llff.py", "cli/video.py"):
        src = open(os.path.join(REPO, "consistentnerf_tpu_torch", rel)).read()
        for banned in ("imageio", "cv2", "PIL", "matplotlib"):
            for form in (f"import {banned}", f"from {banned}"):
                assert form not in src, (rel, form)


def test_vis_paths_import_no_imaging_package():
    """train/vis.py colours, writes PNGs and float TIFFs with no imaging
    package: no import at its top or in any function but visualize_rays
    (a matplotlib plot that nothing calls); nor does data/images.py or
    the tools chip_smoke.py writes its fixtures with import one at their
    top."""
    import ast

    banned = ("imageio", "cv2", "PIL", "matplotlib")

    def imports(nodes):
        for node in nodes:
            for sub in ast.walk(node):
                if isinstance(sub, ast.Import):
                    yield from (a.name for a in sub.names)
                elif isinstance(sub, ast.ImportFrom):
                    yield sub.module or ""

    for rel, exempt in (("consistentnerf_tpu_torch/train/vis.py",
                         {"visualize_rays"}),
                        ("consistentnerf_tpu_torch/data/images.py", set()),
                        ("tools/png_kinds.py", {"main"}),
                        ("tools/lpips_standin.py", set())):
        tree = ast.parse(open(os.path.join(REPO, rel)).read())
        called = [n for n in tree.body if not (
            isinstance(n, ast.FunctionDef) and n.name in exempt)]
        bad = [m for m in imports(called) if m.split(".")[0] in banned]
        assert not bad, (rel, bad)
    names = {n.name for n in ast.parse(open(os.path.join(
        REPO, "consistentnerf_tpu_torch/train/vis.py")).read()).body
        if isinstance(n, ast.FunctionDef)}
    assert {"save_img_f32", "save_img_u8", "visualize_suite",
            "_turbo_colormap", "visualize_rays"} <= names


def test_chip_smoke_imports_no_jax():
    src = open(os.path.join(REPO, "chip_smoke.py")).read()
    for banned in ("import jax", "from jax", "flax", "optax", "orbax",
                   "import msgpack", "from msgpack", "consistentnerf_tpu.",
                   "consistentnerf_tpu "):
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
    """ss_loss goes to the step the JAX rule picks (the one-pass gate is
    the JAX predicate, which accepts it): the one-pass step, the eager
    step without use_fused_train, the two-call step with softLpmask.
    softLpmask with use_fused_train goes to the two-call fused step, as
    in the JAX package, for every fused_kernel, the v1 kinds included;
    the one-pass builder raises for it rather than run another loss."""
    import pytest

    from consistentnerf_tpu_torch import configs
    from consistentnerf_tpu_torch.ops import fused_onepass, fused_train
    from consistentnerf_tpu_torch.train import loop, step as step_lib

    base = configs.Config(netdepth=2, netwidth=32, N_samples=8,
                          N_importance=8, use_fused_train=True,
                          use_onepass_train=True)
    assert fused_onepass.onepass_supported(base)
    ss = base.replace(ss_loss=True)
    assert fused_onepass.onepass_supported(ss)
    for cfg, builder in (
            (ss, fused_onepass.build_onepass_vanilla_train_step),
            (ss.replace(use_fused_train=False),
             step_lib.build_vanilla_train_step),
            (ss.replace(softLpmask=True),
             fused_train.build_fused_vanilla_train_step)):
        step = loop.select_train_step(cfg, None)
        assert step.__qualname__.startswith(builder.__name__ + ".")
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
