"""The JAX package's initial parameters of the method canaries, written
for the port.

    python3 tools/canary_inits.py [--out tests/canary_inits.npz]   # CPU

The canaries (tests/test_generalization_canary.py:24-37,87-100 and
tests/test_mip_canary.py:36-58) train from `train/loop.py::init_state` of
their configs, seeded by `cfg.seed`. This script makes those inits with
the JAX package on the CPU (the card's machine has no JAX) and stores
them as the port's state_dicts (`interop.params_from_jax`,
`interop.mip_params_from_jax`) in one `.npz`: the vanilla canaries (the
interleaved one and both arms of the sparse split share one model shape
and seed, so one init, checked equal) under `vanilla.{name}`, the fine
MLP only (the coarse one starts as its copy, the vanilla trainer's
quirk, checked), and the mip canary under `mip.{name}`. `chip_smoke.py`'s canary phase trains the
port from them on the card.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The model and seed fields of the canaries' configs (the rest does not
# reach the init).
VANILLA = dict(dataset_type="synthetic", backbone="vanilla", netdepth=2,
               netwidth=64, netdepth_fine=2, netwidth_fine=64, multires=6,
               multires_views=2, N_samples=16, N_importance=16, N_rand=256,
               white_bkgd=True, lrate=5e-3, use_tensorboard=False)
VANILLA_ARMS = {  # (loss fields, scene of the arm)
    "interleaved": (dict(n_patches=1, patch_size=8, hardmask=True,
                         with_depth_loss=True),
                    dict(n_views=8, H=64, W=64)),
    "sparse_a": (dict(hardmask=False, with_depth_loss=False, n_patches=0),
                 dict(n_views=8, H=48, W=48, layout="cluster")),
    "sparse_d": (dict(hardmask=True, with_depth_loss=True, n_patches=1,
                      patch_size=8),
                 dict(n_views=8, H=48, W=48, layout="cluster")),
}
MIP = dict(backbone="mipnerf", dataset_type="blender", netdepth=2,
           netwidth=48, mip_num_samples=12, mip_num_levels=2,
           max_deg_point=6, disable_normals=True, N_rand=192,
           batch_size_random=256, random_patch_size=8,
           load_random_rays=True, use_hardmask=True, white_bkgd=True,
           near=2.0, far=6.0, total_iters=500, use_tensorboard=False)


def jax_inits():
    """{key: array} of the port's state_dicts of the JAX inits."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from consistentnerf_tpu.configs import Config
    from consistentnerf_tpu.data import synthetic
    from consistentnerf_tpu.data.random_poses import generate_random_poses
    from consistentnerf_tpu.models.factory import make_model
    from consistentnerf_tpu.train import loop
    from consistentnerf_tpu_torch import interop

    out, vanilla = {}, None
    for name, (kw, scene_kw) in VANILLA_ARMS.items():
        cfg = Config(**VANILLA, **kw)
        scene = synthetic.make_scene(**scene_kw).to_scene_data()
        example = loop.make_batcher(scene, cfg).next_batch()
        state = loop.init_state(cfg, make_model(cfg), example)
        sd = {k: v.numpy() for k, v in interop.params_from_jax(
            jax.device_get(state.params)).items()}
        if vanilla is None:
            vanilla = sd
        elif any(not np.array_equal(sd[k], vanilla[k]) for k in sd):
            raise AssertionError(f"the {name} init is not the others'")
    for k in [k for k in vanilla if k.startswith("coarse.")]:
        if not np.array_equal(vanilla.pop(k), vanilla["fine." + k[7:]]):
            raise AssertionError(f"the init's {k} is not the fine one's")
    out.update({f"vanilla.{k}": v for k, v in vanilla.items()})
    cfg = Config(**MIP)
    scene = synthetic.make_scene(n_views=8, H=48, W=48).to_scene_data(
        n_test=2, interleave_test=True)
    poses = generate_random_poses(scene.poses[scene.i_train], n_poses=100)
    example = loop.make_batcher(scene, cfg, poses).next_batch()
    state = loop.init_state(cfg, make_model(cfg), example)
    out.update({f"mip.{k}": v.numpy() for k, v in interop.mip_params_from_jax(
        jax.device_get(state.params)).items()})
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--out", default=os.path.join(REPO, "tests",
                                                 "canary_inits.npz"))
    args = p.parse_args(argv)
    sys.path.insert(0, REPO)
    inits = jax_inits()
    np.savez_compressed(args.out, **inits)
    print(f"{args.out}: {len(inits)} arrays, "
          f"{sum(v.size for v in inits.values())} floats, "
          f"{os.path.getsize(args.out)} bytes")


if __name__ == "__main__":
    main()
