"""The train-step dispatch of the port against the JAX package's.

A table of small configs goes through both packages: the one-pass gates
(`onepass_supported`, `mip_onepass_supported`) must agree term for term,
lane limits included, and `select_train_step` must pick the counterpart
of the JAX builder (one-pass, two-call or eager) for the vanilla and the
mip backbone. The builders of both packages are replaced by recording
stubs, so no step is built or run.
"""

import pytest

from consistentnerf_tpu import configs as jconfigs
from consistentnerf_tpu.ops import fused_onepass as jop
from consistentnerf_tpu.ops import fused_train as jft
from consistentnerf_tpu.train import loop as jloop
from consistentnerf_tpu.train import step as jstep
from consistentnerf_tpu_torch import configs
from consistentnerf_tpu_torch.ops import fused_onepass as op
from consistentnerf_tpu_torch.ops import fused_train as ft
from consistentnerf_tpu_torch.train import loop
from consistentnerf_tpu_torch.train import step as step_lib
from torch_port_shared import _one_torch_thread  # noqa: F401

VANILLA = dict(backbone="vanilla", netdepth=2, netwidth=32, N_samples=8,
               N_importance=8, multires=4, multires_views=2, hardmask=True,
               use_fused_train=True, use_onepass_train=True)
MIP = dict(backbone="mipnerf", netdepth=2, netwidth=32, mip_num_samples=8,
           max_deg_point=4, disable_normals=True, use_fused_train=True,
           use_onepass_train=True)
TABLE = {
    "hardmask": dict(VANILLA),
    "softLpmask": dict(VANILLA, hardmask=False, softLpmask=True),
    "multires21": dict(VANILLA, multires=21),
    "multires_views21": dict(VANILLA, multires_views=21),
    "no_onepass": dict(VANILLA, use_onepass_train=False),
    "no_fused": dict(VANILLA, use_fused_train=False),
    "softLp_no_fused": dict(VANILLA, softLpmask=True, hardmask=False,
                            use_fused_train=False),
    "no_importance": dict(VANILLA, N_importance=0),
    "mip": dict(MIP),
    "mip_disp_metrics": dict(MIP, compute_disp_metrics=True),
    "mip_normal_metrics": dict(MIP, compute_normal_metrics=True),
    "mip_deg21": dict(MIP, max_deg_point=21),
    "mip_no_onepass": dict(MIP, use_onepass_train=False),
    "mip_no_fused": dict(MIP, use_fused_train=False),
    "mip_no_stop_grad": dict(MIP, stop_level_grad=False),
    "mip_min_deg": dict(MIP, min_deg_point=1),
    "mip_tv_random_rays": dict(MIP, depth_tvnorm_decay=True,
                               load_random_rays=True, anneal_nearfar=True),
}
KERNELS = ("v2", "v2row", "v2h")


def _stub(monkeypatch, module, names, record):
    for name in names:
        monkeypatch.setattr(module, name,
                            lambda *a, _n=name, **k: record.append(_n) or _n)


@pytest.fixture
def stubs(monkeypatch):
    """Record which builder each package's dispatch calls."""
    jax_calls, port_calls = [], []
    _stub(monkeypatch, jop, ["build_onepass_vanilla_train_step",
                             "build_onepass_mip_train_step"], jax_calls)
    _stub(monkeypatch, jft, ["build_fused_vanilla_train_step",
                             "build_fused_mip_train_step"], jax_calls)
    _stub(monkeypatch, jstep, ["build_vanilla_train_step",
                               "build_mip_train_step"], jax_calls)
    _stub(monkeypatch, op, ["build_onepass_vanilla_train_step",
                            "build_onepass_mip_train_step"], port_calls)
    _stub(monkeypatch, ft, ["build_fused_vanilla_train_step",
                            "build_fused_mip_train_step"], port_calls)
    _stub(monkeypatch, step_lib, ["build_vanilla_train_step",
                                  "build_mip_train_step"], port_calls)
    return jax_calls, port_calls


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("name", sorted(TABLE))
def test_dispatch_matches_jax(stubs, name, kernel):
    kw = dict(TABLE[name], fused_kernel=kernel)
    jcfg = jconfigs.Config(use_tensorboard=False, **kw)
    cfg = configs.Config(**kw)
    assert op.onepass_supported(cfg) == jop.onepass_supported(jcfg)
    assert (op.mip_onepass_supported(cfg)
            == jop.mip_onepass_supported(jcfg))
    jax_calls, port_calls = stubs
    assert loop.select_train_step(cfg, None) == \
        jloop.select_train_step(jcfg, None)
    assert port_calls == jax_calls and len(port_calls) == 1


def test_mip_fused_with_normals_raises_in_both(stubs):
    kw = dict(MIP, disable_normals=False)
    with pytest.raises(ValueError, match="disable_normals"):
        jloop.select_train_step(jconfigs.Config(use_tensorboard=False, **kw),
                                None)
    with pytest.raises(ValueError, match="disable_normals"):
        loop.select_train_step(configs.Config(**kw), None)
    assert stubs == ([], [])
