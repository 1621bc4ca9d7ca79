"""Data parallelism over torch.distributed (`parallel/`): two gloo ranks on
the CPU compute the single-process step on the global batch.

The module doubles as the worker: a fixture starts two processes of this
file (`__main__`, one per rank) once a session, which run every
distributed case and write their results to an `.npz` each; the tests
compare them. The cases:
* the eager vanilla step at tests/multihost_worker.py's config and scene
  (3 steps, JAX's init carried), held against the JAX step on the
  8-device mesh within that test's bounds (checksum rtol 1e-5, loss
  1e-4). perturb=0 there, since the packages' random draws differ;
* the one-pass vanilla step (the kernels' plain versions) with every
  mask-true ray on rank 1, the depth loss and a MiDaS / SSIM patch that
  straddles the ranks, perturbed; the eager and one-pass steps with
  ss_loss (reference-view leaves of even H); the eager and one-pass mip
  steps with lossmult different on the two shards and the TV norm on
  (the one-pass step's MiDaS patch rays fill rank 0), each against the
  port's single-process step on the same global batch and draws: loss
  within 1e-6 relative, gradients within 1e-5 relative L2;
* the sharded render of a ray count that needs padding;
* the train CLI over two ranks, and a second run resuming from its
  checkpoint.
In every case the ranks' parameters are bit-identical.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
from torch_port_shared import _one_torch_thread, once_per_run  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300
# tests/multihost_worker.py:49-55 (8 devices), perturb 0.
MULTIHOST = dict(backbone="vanilla", netdepth=2, netwidth=32, N_samples=8,
                 N_importance=0, multires=4, multires_views=2,
                 N_rand=8 * 16 - 64, n_patches=1, patch_size=8,
                 white_bkgd=True, hardmask=True, with_depth_loss=True,
                 use_tensorboard=False, seed=7, perturb=0.0)
# 64 patch rays + 32: rank 0 holds 48 patch rays, rank 1 16 and the 32
# kernel rays.
ONEPASS = dict(backbone="vanilla", netdepth=2, netwidth=32, N_samples=16,
               N_importance=8, multires=4, multires_views=2, N_rand=32,
               n_patches=1, patch_size=8, white_bkgd=True, near=2.0,
               far=6.0, hardmask=True, with_depth_loss=True,
               use_fused_train=True, use_onepass_train=True, seed=3)
MIP = dict(backbone="mipnerf", netdepth=2, netwidth=32, mip_num_samples=8,
           max_deg_point=4, disable_normals=True, N_rand=64,
           white_bkgd=True, compute_depth_metrics=True,
           compute_mono_depth_metrics=True, use_hardmask=True,
           dataset_type="blender", depth_tvnorm_decay=True,
           depth_tvnorm_maxstep=512, depth_tvnorm_loss_mult_start=400.0,
           depth_tvnorm_loss_mult_end=0.1, depth_tvnorm_mask_weight=1.0,
           load_random_rays=True, batch_size_random=128,
           random_patch_size=8, weight_decay_mult=0.1, seed=5)
CASES = ("onepass", "ss_eager", "ss_onepass", "mip_eager", "mip_onepass")
LOSS_RTOL = 1e-6
GRAD_REL = 1e-5


# ---------------------------------------------------------------------------
# The worker (no jax here: it runs the port alone)
# ---------------------------------------------------------------------------

def _flat(tensors):
    return np.concatenate([t.detach().reshape(-1).cpu().numpy()
                           for t in tensors])


def _recording(state):
    """Record each step's summed gradients as the optimizer reads them."""
    opt, seen = state.optimizer, []
    step = opt.step

    def record(count):
        seen.append(_flat([0 * p if p.grad is None else p.grad
                           for p in opt.params]))
        step(count)

    opt.step = record
    return seen


def _run_steps(cfg, batches, init_sd, mesh, n_steps=1):
    from consistentnerf_tpu_torch.data.pipeline import to_device
    from consistentnerf_tpu_torch.train import loop

    state = loop.init_state(cfg, "cpu")
    state.model.load_state_dict(init_sd)
    grads = _recording(state)
    step = loop.select_train_step(cfg, state.model, mesh=mesh)
    losses = []
    for b in batches[:n_steps]:
        state, stats = step(state, to_device(b, "cpu"))
        losses.append(float(stats["loss"]))
    return {"params": _flat(state.model.state_dict().values()),
            "loss": np.asarray(losses), "grads": grads[0], "model":
            state.model}


def _scene(n_views, hw):
    from consistentnerf_tpu_torch.data import synthetic

    return synthetic.make_scene(n_views=n_views, H=hw, W=hw).to_scene_data()


def _worker_cases(mesh, workdir):
    import torch

    from consistentnerf_tpu_torch import configs
    from consistentnerf_tpu_torch.data import random_poses as rp
    from consistentnerf_tpu_torch.data.pipeline import (MipBatcher,
                                                        VanillaBatcher)
    from consistentnerf_tpu_torch.parallel import distributed_render
    from consistentnerf_tpu_torch.train import evaluation, loop
    from consistentnerf_tpu_torch.train.render import build_render_fn

    out = {}
    # The eager step at the multihost config, from JAX's init.
    cfg = configs.Config(**MULTIHOST)
    init = dict(np.load(os.path.join(workdir, "init.npz")))
    init = {k: torch.tensor(v) for k, v in init.items()}
    batcher = VanillaBatcher(_scene(4, 32), cfg, seed=7)
    batches = [batcher.next_batch() for _ in range(3)]
    res = _run_steps(cfg, batches, init, mesh, n_steps=3)
    out["multihost_params"] = res["params"]
    out["multihost_loss"] = res["loss"]
    out["multihost_checksum"] = np.float64(
        res["model"].coarse.pts_linears[0].weight.abs().sum())

    def case(name, cfg, batches, init_sd):
        got = _run_steps(cfg, batches, init_sd, mesh)
        want = _run_steps(cfg, batches, init_sd, None)
        for k in ("params", "loss", "grads"):
            out[f"{name}_{k}"] = got[k]
            out[f"{name}_ref_{k}"] = want[k]

    # One-pass: every mask-true ray on rank 1, a patch across the ranks.
    cfg = configs.Config(**ONEPASS)
    scene = _scene(6, 32)
    b = VanillaBatcher(scene, cfg).next_batch()
    n = b["rgb"].shape[0]
    b["mask"] = (np.arange(n) >= n // 2).astype(np.float32)
    sd = loop.init_state(cfg, "cpu").model.state_dict()
    case("onepass", cfg, [b], sd)
    # ss_loss: the reference view (H = 32) stays whole on each rank.
    for name, kw in (("ss_eager", dict(use_fused_train=False)),
                     ("ss_onepass", {})):
        cfg = configs.Config(**{**ONEPASS, "ss_loss": True, **kw})
        b = VanillaBatcher(scene, cfg).next_batch()
        assert b["ref_image"].shape[0] % 2 == 0
        case(name, cfg, [b], sd)
    # Mip: lossmult differs between the shards, the TV norm is on.
    poses = rp.generate_random_poses(scene.poses[:4], n_poses=8,
                                     rng=np.random.RandomState(0))
    for name, kw in (("mip_eager", {}), ("mip_onepass", dict(
            use_fused_train=True, use_onepass_train=True))):
        cfg = configs.Config(**{**MIP, **kw})
        b = MipBatcher(_scene(4, 32), cfg, random_poses=poses).next_batch()
        n = b["rgb"].shape[0]
        b["rays"].lossmult = np.where(np.arange(n)[:, None] < n // 2, 1.0,
                                      3.0).astype(np.float32)
        sd = loop.init_state(cfg, "cpu").model.state_dict()
        case(name, cfg, [b], sd)
    # The sharded render: 7 x 9 rays, padded to 64.
    cfg = configs.Config(**{**MULTIHOST, "render_chunk_size": 16})
    model = loop.init_state(cfg, "cpu").model
    rays = evaluation.camera_rays_for_view(scene, scene.poses[0],
                                         device="cpu")
    rays = rays.map(lambda x: x[:7, :9])
    got = distributed_render.render_image_sharded(model, cfg, rays, mesh)
    want = build_render_fn(model, cfg)(rays)
    for k in ("rgb", "depth", "acc"):
        out[f"render_{k}"] = got[k]
        out[f"render_ref_{k}"] = want[k].numpy()
    return out


def _worker(coordinator, rank, workdir):
    import torch

    from consistentnerf_tpu_torch.parallel import mesh as mesh_lib

    torch.set_num_threads(1)
    assert mesh_lib.maybe_initialize_distributed(coordinator, 2, rank,
                                                 device="cpu")
    mesh = mesh_lib.create_mesh(device="cpu")
    assert (mesh.world_size, mesh.data_rank) == (2, rank)
    out = _worker_cases(mesh, workdir)
    torch.distributed.destroy_process_group()
    np.savez(os.path.join(workdir, f"rank{rank}.npz"), **out)


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------

def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _spawn(argv_per_rank, cwd, timeout=TIMEOUT):
    """Start one process per argv, wait for all (killing all on a
    timeout) and return their outputs; a failed rank fails the test."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "JAX_PLATFORMS")}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    procs = [subprocess.Popen(argv, cwd=cwd, env=env, text=True,
                              stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE)
             for argv in argv_per_rank]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            assert p.returncode == 0, f"rank failed:\n{out}\n{err}"
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def _jax_multihost(workdir):
    """JAX's init and its 3 steps on the conftest's 8-device mesh at the
    multihost config (tests/test_multihost.py, perturb 0): the init as
    the port's state_dict into init.npz, the checksum and loss into
    jax.npz."""
    import jax

    from consistentnerf_tpu.configs import Config
    from consistentnerf_tpu.data import synthetic
    from consistentnerf_tpu.data.pipeline import VanillaBatcher
    from consistentnerf_tpu.models.factory import make_model
    from consistentnerf_tpu.parallel import mesh as mesh_lib
    from consistentnerf_tpu.train import loop as loop_lib
    from consistentnerf_tpu.train import step as step_lib
    from consistentnerf_tpu_torch import interop

    assert len(jax.devices()) == 8
    cfg = Config(**MULTIHOST)
    scene = synthetic.make_scene(n_views=4, H=32, W=32).to_scene_data()
    batcher = VanillaBatcher(scene, cfg, seed=7)
    mesh = mesh_lib.create_mesh()
    batch = batcher.next_batch()
    state = loop_lib.init_state(cfg, make_model(cfg), batch)
    np.savez(os.path.join(workdir, "init.npz"), **{
        k: v.numpy() for k, v in interop.params_from_jax(
            jax.device_get(state.params)).items()})
    ts = step_lib.build_train_step(make_model(cfg), cfg, donate=False)
    key = jax.random.PRNGKey(cfg.seed)
    sharded = mesh_lib.shard_batch(batch, mesh)
    for _ in range(3):
        state, stats = ts(state, sharded, key)
        sharded = mesh_lib.shard_batch(batcher.next_batch(), mesh)
    k = np.asarray(
        jax.device_get(state.params["params"]["coarse"]["pts_0"]["kernel"]))
    np.savez(os.path.join(workdir, "jax.npz"), checksum=np.abs(k).sum(),
             loss=np.float32(stats["loss"]))


@pytest.fixture(scope="module")
def ranks(request, tmp_path_factory):
    """JAX's reference and both ranks' results of every case, made once a
    run (`once_per_run`)."""
    return once_per_run(request,
                        lambda: _ranks(tmp_path_factory.mktemp("ranks")))


def _ranks(workdir):
    _jax_multihost(str(workdir))
    coord = f"127.0.0.1:{_free_port()}"
    _spawn([[sys.executable, os.path.abspath(__file__), coord, str(r),
             str(workdir)] for r in range(2)], str(workdir))
    return ([dict(np.load(workdir / f"rank{r}.npz")) for r in range(2)],
            dict(np.load(workdir / "jax.npz")))


def test_two_ranks_eager_step_matches_jax_mesh(ranks):
    (r0, r1), jax_ref = ranks
    np.testing.assert_array_equal(r0["multihost_params"],
                                  r1["multihost_params"])
    np.testing.assert_array_equal(r0["multihost_loss"], r1["multihost_loss"])
    np.testing.assert_allclose(r0["multihost_checksum"], jax_ref["checksum"],
                               rtol=1e-5)
    np.testing.assert_allclose(r0["multihost_loss"][-1], jax_ref["loss"],
                               rtol=1e-4)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.mark.parametrize("name", CASES)
def test_two_ranks_match_the_single_process_step(ranks, name):
    ranks = ranks[0]
    r0, r1 = ranks
    np.testing.assert_array_equal(r0[f"{name}_params"], r1[f"{name}_params"])
    np.testing.assert_array_equal(r0[f"{name}_loss"], r1[f"{name}_loss"])
    for r in ranks:
        np.testing.assert_allclose(r[f"{name}_loss"], r[f"{name}_ref_loss"],
                                   rtol=LOSS_RTOL)
        assert _rel_l2(r[f"{name}_grads"], r[f"{name}_ref_grads"]) \
            < GRAD_REL, name
    assert np.isfinite(r0[f"{name}_params"]).all()


def test_sharded_render_matches_single_process(ranks):
    ranks = ranks[0]
    for r in ranks:
        for k in ("rgb", "depth", "acc"):
            assert r[f"render_{k}"].shape == r[f"render_ref_{k}"].shape
            np.testing.assert_allclose(r[f"render_{k}"],
                                       r[f"render_ref_{k}"], atol=1e-5)
    np.testing.assert_array_equal(ranks[0]["render_rgb"],
                                  ranks[1]["render_rgb"])


def test_train_cli_over_two_ranks_and_resume(tmp_path):
    """`cli/train.py` over two gloo ranks on `mesh_shape` [2]: 2 steps
    write one checkpoint (rank 0), and a second run resumes from it."""
    import torch

    def run(num_steps):
        coord = f"127.0.0.1:{_free_port()}"
        sets = ["dataset_type=synthetic", "synthetic_hw=16",
                "synthetic_views=3", "netdepth=2", "netwidth=32",
                "N_samples=8", "N_importance=8", "multires=4",
                "multires_views=2", "N_rand=32", "n_patches=1",
                "patch_size=4", "white_bkgd=true", "i_print=1",
                "checkpoint_every=2", "use_tensorboard=false",
                f"basedir={tmp_path}", "expname=two", "num_processes=2",
                f"coordinator_address={coord}", "mesh_shape=[2]"]
        argv = [sys.executable, "-m", "consistentnerf_tpu_torch.cli.train",
                "--device", "cpu", "--num-steps", str(num_steps)]
        argv += [x for s in sets for x in ("--set", s)]
        return _spawn([argv + ["--set", f"process_id={r}"]
                       for r in range(2)], str(tmp_path))

    ckpts = tmp_path / "two" / "checkpoints"
    outs = run(2)
    assert "step 2/2" in outs[0] and "step 2/2" not in outs[1]
    assert sorted(os.listdir(ckpts)) == ["step_00000002.pt"]
    outs = run(3)
    assert "resumed from step 2" in outs[0] and "step 3/3" in outs[0]
    assert sorted(os.listdir(ckpts)) == ["step_00000002.pt",
                                         "step_00000003.pt"]
    sd = torch.load(ckpts / "step_00000003.pt", weights_only=True)
    assert sd["step"] == 3


def test_shard_batch_and_mesh_contract():
    """One process, no spawn: the ray-axis leaves are sliced, the
    reference view and bounds kept whole, an indivisible count raises;
    mesh_shape must hold the world size."""
    import dataclasses

    import torch

    from consistentnerf_tpu_torch.core.rays import Rays
    from consistentnerf_tpu_torch.parallel import mesh as mesh_lib

    single = mesh_lib.create_mesh(device="cpu")
    assert (single.world_size, single.data_size, single.active) == (1, 1,
                                                                     False)
    assert mesh_lib.local_batch_slice(64) == 64
    with pytest.raises(ValueError, match="the group has 1"):
        mesh_lib.create_mesh([2], device="cpu")
    with pytest.raises(ValueError, match="axis names"):
        mesh_lib.create_mesh([1, 1], device="cpu")
    assert not mesh_lib.maybe_initialize_distributed(None, 1, 0)
    # A mesh of two as rank 1 sees it (no group: the slicing alone).
    two = dataclasses.replace(single, shape=(2,), data_size=2, data_rank=1,
                              group=object())
    assert mesh_lib.local_batch_slice(64, two) == 32
    with pytest.raises(ValueError, match="not divisible"):
        mesh_lib.local_batch_slice(63, two)
    n = 8  # the ray count; the reference view has 8 rows too
    ones = torch.ones(n, 1)
    batch = {"rgb": torch.arange(3 * n).reshape(n, 3).float(),
             "mask": torch.arange(n).float(),
             "ref_image": torch.zeros(n, 4, 3), "K": torch.eye(3),
             "bounds": torch.tensor([2.0, 6.0]),
             "rays": Rays(*(ones * i for i in range(7)))}
    spec = mesh_lib.leaf_sharding(batch, two)
    assert {k for k, v in spec.items() if v["kind"] == "sharded"} == {
        "rgb", "mask", "rays"}
    local = mesh_lib.shard_batch(batch, two)
    assert torch.equal(local["mask"], torch.arange(4, 8).float())
    assert local["rays"].origins.shape == (4, 1)
    assert local["ref_image"] is batch["ref_image"]
    with pytest.raises(ValueError, match="do not divide"):
        mesh_lib.shard_batch({"rgb": torch.zeros(7, 3)}, two)
    draws = {"t_rand": torch.arange(n).float()[:, None],
             "ss": {"gate": torch.tensor(True), "u": torch.zeros(n, 2)}}
    got = mesh_lib.shard_tree(draws, n, mesh_lib.data_slice(n, two))
    assert torch.equal(got["t_rand"][:, 0], torch.arange(4, 8).float())
    assert got["ss"]["gate"] is draws["ss"]["gate"]
    assert got["ss"]["u"].shape == (4, 2)


if __name__ == "__main__":
    sys.path.insert(0, REPO)
    _worker(sys.argv[1], int(sys.argv[2]), sys.argv[3])
