"""The rest of the port's command line and data surface against the JAX
package: `cli/metrics.py`, `cli/jobs.py` (a sweep's dry run, the watch
daemon in a thread), `data/multicam.py` on a fixture whose PNGs the
port's writer makes and the JAX package's PIL path reads, the mip
canary's schedule check (tests/test_mip_canary.py, training nothing),
and the entry points that run on `cuda` unless the caller asks for the
CPU.
"""

import fnmatch
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from consistentnerf_tpu_torch import configs, interop
from consistentnerf_tpu_torch.cli import common, import_mipnerf_ckpt
from consistentnerf_tpu_torch.cli import import_torch_ckpt, jobs, metrics
from consistentnerf_tpu_torch.data import images
from consistentnerf_tpu_torch.data import random_poses as rp
from consistentnerf_tpu_torch.data.multicam import (MulticamBatcher,
                                                    MulticamDataset)
from consistentnerf_tpu_torch.models.factory import make_model
from consistentnerf_tpu_torch.train.lpips import LPIPS
from consistentnerf_tpu_torch.train.state import make_lr_schedule
from torch_port_shared import _one_torch_thread  # noqa: F401

RAY_FIELDS = ("origins", "directions", "viewdirs", "radii", "lossmult",
              "near", "far")


def test_metrics_aggregator_matches_jax(tmp_path, capsys):
    """tests/test_eval_vis.py:84-95's round trip, and the per-metric
    files of a directory without metrics.txt, against the JAX CLI."""
    from consistentnerf_tpu.cli import metrics as jmetrics

    for name, body in (("exp1", "psnr: 20.0\nssim: 0.5\n"),
                       ("exp2", "psnr: 30.0\nssim: 0.7\nnote: n/a\n")):
        d = tmp_path / name / "test_preds"
        d.mkdir(parents=True)
        (d / "metrics.txt").write_text(body)
    d = tmp_path / "exp3" / "test_preds"
    d.mkdir(parents=True)
    (d / "metric_psnr_500.txt").write_text("28.5\n")
    (d / "metric_lpips_500.txt").write_text("0.25\n")
    dirs = [str(tmp_path / f"exp{i}") for i in (1, 2, 3)]
    got = metrics.collect(dirs)
    assert got == jmetrics.collect(dirs)
    assert got["psnr"] == pytest.approx((20.0 + 30.0 + 28.5) / 3)
    assert got["ssim"] == pytest.approx(0.6)
    assert metrics.main([str(tmp_path / "exp*")]) == got
    assert "psnr: 26.1667" in capsys.readouterr().out
    assert metrics.main([str(tmp_path / "none*")]) == {}


def test_jobs_sweep_dry_run_names_the_presets(capsys):
    from consistentnerf_tpu.configs import scenes as jscenes

    glob = "fern_*"
    want = [n for n in jscenes.list_scenes() if fnmatch.fnmatch(n, glob)]
    assert want
    assert jobs.main(["sweep", "--preset-glob", glob, "--dry-run"]) == want
    assert f"sweeping {len(want)} presets" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="no presets match"):
        jobs.sweep("no_such_*", [], dry_run=True)


def test_jobs_watch_runs_a_job_and_stops_one(tmp_path):
    """The daemon in a thread, polling every 0.2 s: a job that ends at
    once leaves its exit code in `.done`; a long one is stopped by its
    `.stop` file, which is consumed."""
    jobdir = tmp_path / "jobs"
    jobdir.mkdir()
    (jobdir / "fast.job").write_text("--list-scenes")
    (jobdir / "slow.job").write_text(
        f"--device cpu --set dataset_type=synthetic --set synthetic_hw=16 "
        f"--set netdepth=2 --set netwidth=32 --set N_samples=8 "
        f"--set N_importance=0 --set N_rand=32 --set n_patches=0 "
        f"--set use_tensorboard=false --set basedir={tmp_path} "
        f"--num-steps 1000000")
    done = threading.Event()
    t = threading.Thread(target=jobs.watch, args=(str(jobdir), 0.2),
                         kwargs={"until": done.is_set})
    t.start()
    try:
        deadline = time.time() + 120
        while (not (jobdir / "fast.job.done").exists()
               and time.time() < deadline):
            time.sleep(0.2)
        assert (jobdir / "fast.job.done").read_text() == "0"
        assert "fern_3view" in (jobdir / "fast.log").read_text()
        assert not (jobdir / "slow.job.done").exists()
        (jobdir / "slow.stop").write_text("")
        while (not (jobdir / "slow.job.done").exists()
               and time.time() < deadline):
            time.sleep(0.2)
        assert (jobdir / "slow.job.done").read_text() != "0"
        assert not (jobdir / "slow.stop").exists()
    finally:
        done.set()
        t.join(timeout=60)
    assert not t.is_alive()
    # A finished job is not run again.
    assert sorted(os.listdir(jobdir)) == [
        "fast.job", "fast.job.done", "fast.log", "slow.job", "slow.job.done",
        "slow.log"]


def _write_multicam_fixture(root, n_views=4):
    """tests/test_multicam.py's fixture, its PNGs by the port's writer."""
    rng = np.random.RandomState(0)
    meta = {"train": {k: [] for k in ("file_path", "pix2cam", "cam2world",
                                      "width", "height", "lossmult", "near",
                                      "far")}}
    for i in range(n_views):
        scale = 2 ** (i % 2)  # two scales
        h = w = 32 // scale
        fname = f"im_{i}.png"
        images.write_png(str(root / fname),
                         (rng.rand(h, w, 4) * 255).astype(np.uint8))
        focal = 40.0 / scale
        cam2pix = np.array([[focal, 0, w / 2], [0, focal, h / 2], [0, 0, 1]])
        c2w = np.eye(4)[:3]
        c2w[:, 3] = rng.randn(3)
        m = meta["train"]
        m["file_path"].append(fname)
        m["pix2cam"].append(np.linalg.inv(cam2pix).tolist())
        m["cam2world"].append(c2w.tolist())
        m["width"].append(w)
        m["height"].append(h)
        m["lossmult"].append(float(scale**2))
        m["near"].append(2.0)
        m["far"].append(6.0)
    with open(root / "metadata.json", "w") as f:
        json.dump(meta, f)


def test_multicam_dataset_and_batcher_match_jax(tmp_path):
    """tests/test_multicam.py::test_multicam_dataset_and_batcher's twin:
    the images, every ray field of every view and three batches equal
    the JAX package's."""
    from consistentnerf_tpu.data import multicam as jmulticam

    _write_multicam_fixture(tmp_path)
    ds = MulticamDataset(str(tmp_path), "train")
    ref = jmulticam.MulticamDataset(str(tmp_path), "train")
    assert ds.n_examples == ref.n_examples == 4
    assert ds.images[0].shape != ds.images[1].shape
    for a, b in zip(ds.images, ref.images):
        np.testing.assert_array_equal(a, b)
    for f in RAY_FIELDS:
        for a, b in zip(getattr(ds.rays, f), getattr(ref.rays, f)):
            np.testing.assert_array_equal(a, b, err_msg=f)
    assert float(np.asarray(ds.rays.lossmult[1])[0, 0, 0]) == 4.0
    got, want = MulticamBatcher(ds, 64, seed=3), jmulticam.MulticamBatcher(
        ref, 64, seed=3)
    for _ in range(3):
        g, w = got.next_batch(), want.next_batch()
        assert g.keys() == w.keys()
        for k in g:
            if k == "rays":
                for f in RAY_FIELDS:
                    np.testing.assert_array_equal(
                        getattr(g[k], f), np.asarray(getattr(w[k], f)))
            else:
                np.testing.assert_array_equal(g[k], np.asarray(w[k]))
    assert g["rays"].origins.shape == (64, 3) and g["rgb"].shape == (64, 3)
    assert set(np.unique(g["rays"].lossmult)) <= {1.0, 4.0}


def _mip_recipe_cfg(**kw) -> configs.Config:
    """tests/test_mip_canary.py::mip_recipe_cfg in the port's Config."""
    base = dict(
        backbone="mipnerf", dataset_type="blender", netdepth=2, netwidth=48,
        mip_num_samples=12, mip_num_levels=2, max_deg_point=6,
        disable_normals=True, N_rand=192, batch_size_random=256,
        random_patch_size=8, load_random_rays=True,
        depth_tvnorm_loss_mult=0.1, depth_tvnorm_decay=True,
        depth_tvnorm_maxstep=64, depth_tvnorm_loss_mult_start=400.0,
        depth_tvnorm_loss_mult_end=0.1, use_hardmask=True, white_bkgd=True,
        near=2.0, far=6.0, anneal_nearfar=True, anneal_nearfar_steps=64,
        anneal_nearfar_perc=0.0001, anneal_mid_perc=1.0, lr_init=2e-3,
        lr_final=2e-5, lr_delay_steps=32, lr_delay_mult=0.01,
        grad_max_norm=0.1, grad_max_val=0.1, density_noise=1.0,
        total_iters=500, use_tensorboard=False, checkpoint_every=10**9)
    base.update(kw)
    return configs.Config(**base)


def _schedule_is_sane(cfg, num_steps: int) -> bool:
    """tests/test_mip_canary.py::schedule_is_sane on the port's schedule
    and annealing."""
    sched = make_lr_schedule(cfg)
    peak = max(float(sched(s)) for s in
               range(0, num_steps, max(1, num_steps // 50)))
    decayed = float(sched(num_steps - 1)) <= 0.05 * peak
    near_end, far_end = rp.anneal_nearfar_values(
        num_steps - 1, cfg.near, cfg.far, cfg.anneal_nearfar_steps,
        cfg.anneal_nearfar_perc, cfg.anneal_mid_perc,
    ) if cfg.anneal_nearfar else (cfg.near, cfg.far)
    return (decayed and abs(near_end - cfg.near) < 1e-6
            and abs(far_end - cfg.far) < 1e-6)


def test_j_style_schedule_fails_sanity_and_reconcile_repairs_it():
    """The twin of tests/test_mip_canary.py's schedule test: the canary's
    recipe is sane at 500 steps, the queue-J config (the 50k horizon and
    the default anneal) is not, and the CLI's reconciliation repairs it."""
    assert _schedule_is_sane(_mip_recipe_cfg(), 500)
    j_cfg = _mip_recipe_cfg(total_iters=50000, anneal_nearfar_steps=2000,
                            anneal_nearfar_perc=0.2, anneal_mid_perc=0.5)
    assert not _schedule_is_sane(j_cfg, 500)

    class _Args:
        config = None
        overrides = []
        num_steps = 500

    fixed = common.reconcile_schedule_horizon(j_cfg, _Args())
    assert fixed.total_iters == 500
    assert _schedule_is_sane(fixed, 500)


VANILLA = dict(netdepth=2, netwidth=32, multires=4, multires_views=2)
MIP = dict(backbone="mipnerf", netdepth=2, netwidth=32, max_deg_point=4)


def _import_torch_ckpt(tmp_path, **kw):
    cfg = configs.Config(**VANILLA)
    model = make_model(cfg, "cpu")
    tar = str(tmp_path / "000005.tar")
    torch.save({"global_step": 5,
                "network_fn_state_dict": model.coarse.state_dict(),
                "network_fine_state_dict": model.fine.state_dict()}, tar)
    return import_torch_ckpt.import_checkpoint(tar, cfg, **kw)


def _import_mipnerf_ckpt(tmp_path, monkeypatch, **kw):
    cfg = configs.Config(**MIP)
    tree = interop.mip_params_to_jax(make_model(cfg, "cpu").state_dict())
    monkeypatch.setattr(import_mipnerf_ckpt, "load_pretrained_state_dict",
                        lambda path: {})
    monkeypatch.setattr(import_mipnerf_ckpt, "pretrained_to_params",
                        lambda sd, depth: (tree, 7))
    return import_mipnerf_ckpt.import_checkpoint(str(tmp_path), cfg, **kw)


@pytest.mark.parametrize("entry", ["import_torch_ckpt",
                                   "import_mipnerf_ckpt", "lpips"])
def test_entry_points_default_to_cuda(tmp_path, monkeypatch, entry):
    """Called without a device, each runs on `cuda`, so on a machine
    without one it raises; with device="cpu" it runs there."""
    if torch.cuda.is_available():
        pytest.skip("checks the refusal of the cuda default without a card")
    call = {"import_torch_ckpt": lambda **kw: _import_torch_ckpt(
                tmp_path, **kw),
            "import_mipnerf_ckpt": lambda **kw: _import_mipnerf_ckpt(
                tmp_path, monkeypatch, **kw),
            "lpips": lambda **kw: LPIPS(None, **kw)}[entry]
    with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
        call()
    got = call(device="cpu")
    tensors = (got.params["lins"] if entry == "lpips"
               else list(got.model.parameters()))
    assert all(t.device.type == "cpu" for t in tensors)
