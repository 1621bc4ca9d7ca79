"""The resampling kernels: the vanilla fine level's inverse CDF and merge
(kernel #8) and the mip level's blurpool resampler (kernel #9).

`sample_pdf_merged` is the port of `consistentnerf_tpu/ops/pdf_merge.py::
sample_pdf_merged`: `sort(concat(z_c, sample_pdf(z_mid(z_c), w, S_i, u)))`
and the samples, for ascending draws `u`. On a CUDA tensor it launches
the hand-written kernel `csrc/pdf_merge.cu` (or raises); on a CPU tensor
it runs the plain version `plain_sample_pdf_merged`. `mip_resample_t_vals`
is the port of `mip_resample_t_vals`: blurpool, padding and the hardened
inverse CDF of `core.sampling.resample_along_rays` without the cone
casting, from `csrc/mip_resample.cu` or `plain_mip_resample_t_vals`.

Both kernels need ascending draws. The deterministic draws are a
linspace, and the mip draws (`core.sampling.piecewise_pdf_draws`) are
ascending by construction. The vanilla stochastic draws are iid uniforms
that the reference sorts away with the merged depths; `sorted_uniform`
makes their order statistics directly, the same set of depths in
distribution (`fine_z_draws`).

`fine_z_vals` routes the vanilla fine level: through kernel #8 with
`use_kernel` (and S_c, S_i <= 128), else through the plain chain
`sort(concat(z_vals, sample_pdf(...)))`, the JAX package's default
(`use_pdf_kernel=False`). The resampled depths are detached either way.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from consistentnerf_tpu_torch.core import sampling
from consistentnerf_tpu_torch.ops import _build
from consistentnerf_tpu_torch.ops.fused_mlp_v2 import _check_stream

KERNEL = "pdf_merge"
MIP_KERNEL = "mip_resample"
MAX_SAMPLES = 128  # the kernels' (and the TPU kernels') row limit
# Kernel launches since import (or since the caller last reset them).
launches = 0
mip_launches = 0


def sorted_uniform(e: torch.Tensor) -> torch.Tensor:
    """Ascending iid-U[0, 1) order statistics along the last axis from the
    uniforms `e` [..., n + 1], without a sort: u_(i) = S_i / S_{n+1} with
    S the prefix sums of the Exp(1) spacings -log(1 - e) (Renyi's
    representation). Returns [..., n]."""
    s = torch.cumsum(-torch.log1p(-e), -1)
    return s[..., :-1] / s[..., -1:]


def fine_z_draws(e: Optional[torch.Tensor], n: int, s_i: int, det: bool,
                 device=None) -> torch.Tensor:
    """The draws of `sample_pdf_merged` for n rays: the deterministic
    linspace (the draws of `sampling.sample_pdf`'s det branch), or the
    order statistics of the uniforms `e` [n, s_i + 1]."""
    if det:
        return torch.linspace(0.0, 1.0, s_i, device=device).expand(n, s_i)
    return sorted_uniform(e)


def plain_sample_pdf_merged(z_c: torch.Tensor, w: torch.Tensor,
                            u: torch.Tensor):
    """The plain version of `sample_pdf_merged` on any device."""
    z_mid = 0.5 * (z_c[..., 1:] + z_c[..., :-1])
    z_s = sampling.sample_pdf(z_mid, w, u.shape[-1], u=u)
    merged, _ = torch.sort(torch.cat([z_c, z_s], -1), -1)
    return merged, z_s


@functools.cache
def _kernel():
    fn = _build.load(KERNEL).pdf_merge
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def sample_pdf_merged(z_c: torch.Tensor, w: torch.Tensor, u: torch.Tensor):
    """Inverse-CDF fine sampling plus the merge with the coarse depths
    (kernel #8): z_c [N, S_c] ascending, w [N, S_c - 2] the interior
    compositing weights, u [N, S_i] ASCENDING draws in [0, 1]. Returns
    (merged [N, S_c + S_i], z_samples [N, S_i]). CPU tensors take the
    plain version; CUDA tensors launch the kernel or raise."""
    n, s_c = z_c.shape
    s_i = u.shape[-1]
    if tuple(w.shape) != (n, s_c - 2) or tuple(u.shape) != (n, s_i):
        raise ValueError(f"weights {tuple(w.shape)} and draws "
                         f"{tuple(u.shape)} do not fit depths {(n, s_c)}")
    if not (3 <= s_c <= MAX_SAMPLES and 1 <= s_i <= MAX_SAMPLES):
        raise ValueError(f"sample_pdf_merged takes 3..{MAX_SAMPLES} coarse "
                         f"and 1..{MAX_SAMPLES} fine samples, not {s_c}, "
                         f"{s_i}")
    if z_c.device.type == "cpu":
        return plain_sample_pdf_merged(z_c, w, u)
    if z_c.device.type != "cuda":
        raise ValueError(f"no pdf kernel for device {z_c.device}")
    dev = z_c.device
    for name, t, cols in (("z_c", z_c, s_c), ("w", w, s_c - 2),
                          ("u", u, s_i)):
        _check_stream(name, t, n, cols, dev)
    merged = torch.empty((n, s_c + s_i), dtype=torch.float32, device=dev)
    z_s = torch.empty((n, s_i), dtype=torch.float32, device=dev)
    if n == 0:
        return merged, z_s
    err = _kernel()(z_c.data_ptr(), w.data_ptr(), u.data_ptr(),
                    merged.data_ptr(), z_s.data_ptr(), n, s_c, s_i,
                    torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: cudaError_t {err}")
    global launches
    launches += 1
    return merged, z_s


def plain_mip_resample_t_vals(t_vals: torch.Tensor, weights: torch.Tensor,
                              u: torch.Tensor,
                              resample_padding: float) -> torch.Tensor:
    """The plain version of `mip_resample_t_vals` on any device: the
    blurpool and inverse-CDF math of `sampling.resample_along_rays` on
    the given draws."""
    weights_pad = torch.cat([weights[..., :1], weights, weights[..., -1:]],
                            -1)
    weights_max = torch.maximum(weights_pad[..., :-1], weights_pad[..., 1:])
    weights_blur = 0.5 * (weights_max[..., :-1] + weights_max[..., 1:])
    return sampling.inverse_cdf(t_vals, weights_blur + resample_padding, u)


@functools.cache
def _mip_kernel():
    fn = _build.load(MIP_KERNEL).mip_resample
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def mip_resample_t_vals(t_vals: torch.Tensor, weights: torch.Tensor,
                        u: torch.Tensor,
                        resample_padding: float) -> torch.Tensor:
    """Blurpool, padding and the hardened inverse CDF (kernel #9): t_vals
    [N, S+1] ascending fenceposts, weights [N, S], u [N, S+1] ASCENDING
    draws in [0, 1), the padding a host scalar. Returns the new
    fenceposts [N, S+1]. CPU tensors take the plain version; CUDA tensors
    launch the kernel or raise."""
    n, sp1 = t_vals.shape
    if tuple(weights.shape) != (n, sp1 - 1) or tuple(u.shape) != (n, sp1):
        raise ValueError(f"weights {tuple(weights.shape)} and draws "
                         f"{tuple(u.shape)} do not fit fenceposts "
                         f"{(n, sp1)}")
    if not 2 <= sp1 <= MAX_SAMPLES:
        raise ValueError(f"mip_resample_t_vals takes 2..{MAX_SAMPLES} "
                         f"fenceposts, not {sp1}")
    if t_vals.device.type == "cpu":
        return plain_mip_resample_t_vals(t_vals, weights, u,
                                         resample_padding)
    if t_vals.device.type != "cuda":
        raise ValueError(f"no mip resampling kernel for device "
                         f"{t_vals.device}")
    dev = t_vals.device
    for name, t, cols in (("t_vals", t_vals, sp1),
                          ("weights", weights, sp1 - 1), ("u", u, sp1)):
        _check_stream(name, t, n, cols, dev)
    out = torch.empty((n, sp1), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    err = _mip_kernel()(t_vals.data_ptr(), weights.data_ptr(), u.data_ptr(),
                        out.data_ptr(), n, sp1 - 1, float(resample_padding),
                        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{MIP_KERNEL} launch failed: cudaError_t {err}")
    global mip_launches
    mip_launches += 1
    return out


def fine_z_vals(
    z_vals: torch.Tensor,  # [N, S_c] ascending coarse depths
    weights: torch.Tensor,  # [N, S_c] compositing weights (full row)
    n_importance: int,
    u: Optional[torch.Tensor] = None,
    det: bool = True,
    use_kernel: bool = False,
    return_samples: bool = False,
):
    """`sort(concat(z_vals, sample_pdf(z_mid, w[..., 1:-1], S_i)))`, with
    the resampled depths detached. `u` [N, S_i] gives the draws of a
    stochastic level; the kernel route (`use_kernel`, S_c and S_i <= 128)
    needs them ascending (`fine_z_draws`)."""
    if (use_kernel and z_vals.ndim == 2 and z_vals.shape[-1] <= MAX_SAMPLES
            and n_importance <= MAX_SAMPLES):
        n = z_vals.shape[0]
        if det:
            u = fine_z_draws(None, n, n_importance, True, z_vals.device)
        elif u is None:
            raise ValueError("stochastic fine_z_vals needs its draws `u`")
        z_all, z_samples = sample_pdf_merged(
            z_vals.detach().float().contiguous(),
            weights[..., 1:-1].detach().float().contiguous(),
            u.float().contiguous())
    else:
        z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        z_samples = sampling.sample_pdf(
            z_mid, weights[..., 1:-1], n_importance, u=u, det=det
        ).detach()
        z_all, _ = torch.sort(torch.cat([z_vals, z_samples], -1), -1)
    if return_samples:
        return z_all, z_samples
    return z_all
