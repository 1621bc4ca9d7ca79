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

Both kernels read each input row through its row stride, so a caller
hands over views (the interior weights `w[..., 1:-1]`, an expanded
linspace of draws with row stride 0) without a copy. An input's last
dimension must be unit-stride, fp32 and on the first input's device, on
every device; the ops raise otherwise.

`fine_z_vals` routes the vanilla fine level: through kernel #8 with
`use_kernel` (and S_c, S_i <= 128), else through the plain chain
`sort(concat(z_vals, sample_pdf(...)))`, the JAX package's default
(`use_pdf_kernel=False`). The resampled depths are detached either way.

Neither op takes a mesh: the JAX package shard_maps #8 / #9 over its
mesh (`ops/pdf_merge.py:351-372`), while each rank of a run over
`parallel/mesh.py` launches them on its own rays already.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from consistentnerf_tpu_torch.core import sampling
from consistentnerf_tpu_torch.ops import _build

KERNEL = "pdf_merge"
MIP_KERNEL = "mip_resample"
MAX_SAMPLES = 128  # the kernels' (and the TPU kernels') row limit
# The C entries' parameters in order: p a pointer (the last one the
# stream), i an int, f a float.
PDF_ARGS = "pipipippiiip"
MIP_ARGS = "pipipipiifp"
_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "f": ctypes.c_float}
# Kernel launches since import (or since the caller last reset them).
launches = 0
mip_launches = 0


def row_stride(name: str, t: torch.Tensor, n: int, cols: int,
               device) -> int:
    """Checks that `t` is an fp32 [n, cols] tensor on `device` whose last
    dimension is unit-stride; returns its row stride in elements (0 where
    one row stands for every ray)."""
    if t.dtype != torch.float32 or t.shape != (n, cols) or t.device != device:
        raise ValueError(f"{name} must be an fp32 [{n}, {cols}] tensor on "
                         f"{device}, not {t.dtype} {list(t.shape)} on "
                         f"{t.device}")
    row, col = t.stride()
    if col != 1 and cols > 1:
        raise ValueError(f"{name} must be unit-stride in its last "
                         f"dimension, not strides {t.stride()}")
    if row >= 2 ** 31:
        raise ValueError(f"{name}'s row stride {row} does not fit the "
                         "kernel's int")
    return row


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
    fn.argtypes = [_CTYPES[k] for k in PDF_ARGS]
    fn.restype = ctypes.c_int
    return fn


def pdf_merge_launch(z_c, w, u, merged, z_s, strides, stream: int) -> None:
    """Launches #8 on checked rows: `strides` the row strides of z_c, w
    and u (`row_stride`), merged and z_s allocated contiguous, `stream`
    the CUDA stream's handle."""
    n, s_c = z_c.shape
    err = _kernel()(z_c.data_ptr(), strides[0], w.data_ptr(), strides[1],
                    u.data_ptr(), strides[2], merged.data_ptr(),
                    z_s.data_ptr(), n, s_c, u.shape[1], stream)
    if err != 0:
        raise RuntimeError(f"{KERNEL} launch failed: cudaError_t {err}")
    global launches
    launches += 1


def sample_pdf_merged(z_c: torch.Tensor, w: torch.Tensor, u: torch.Tensor):
    """Inverse-CDF fine sampling plus the merge with the coarse depths
    (kernel #8): z_c [N, S_c] ascending, w [N, S_c - 2] the interior
    compositing weights, u [N, S_i] ASCENDING draws in [0, 1]; rows may be
    views (`row_stride`). Returns (merged [N, S_c + S_i], z_samples
    [N, S_i]). CPU tensors take the plain version; CUDA tensors launch the
    kernel or raise."""
    n, s_c = z_c.shape
    s_i = u.shape[-1]
    if not (3 <= s_c <= MAX_SAMPLES and 1 <= s_i <= MAX_SAMPLES):
        raise ValueError(f"sample_pdf_merged takes 3..{MAX_SAMPLES} coarse "
                         f"and 1..{MAX_SAMPLES} fine samples, not {s_c}, "
                         f"{s_i}")
    dev = z_c.device
    strides = (row_stride("z_c", z_c, n, s_c, dev),
               row_stride("w", w, n, s_c - 2, dev),
               row_stride("u", u, n, s_i, dev))
    if dev.type == "cpu":
        return plain_sample_pdf_merged(z_c, w, u)
    if dev.type != "cuda":
        raise ValueError(f"no pdf kernel for device {dev}")
    merged = torch.empty((n, s_c + s_i), dtype=torch.float32, device=dev)
    z_s = torch.empty((n, s_i), dtype=torch.float32, device=dev)
    if n:
        pdf_merge_launch(z_c, w, u, merged, z_s, strides,
                         torch.cuda.current_stream(dev).cuda_stream)
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
    fn.argtypes = [_CTYPES[k] for k in MIP_ARGS]
    fn.restype = ctypes.c_int
    return fn


def mip_resample_launch(t_vals, weights, u, out, strides, padding: float,
                        stream: int) -> None:
    """Launches #9 on checked rows: `strides` the row strides of t_vals,
    weights and u (`row_stride`), out allocated contiguous, `stream` the
    CUDA stream's handle."""
    n, sp1 = t_vals.shape
    err = _mip_kernel()(t_vals.data_ptr(), strides[0], weights.data_ptr(),
                        strides[1], u.data_ptr(), strides[2], out.data_ptr(),
                        n, sp1 - 1, float(padding), stream)
    if err != 0:
        raise RuntimeError(f"{MIP_KERNEL} launch failed: cudaError_t {err}")
    global mip_launches
    mip_launches += 1


def mip_resample_t_vals(t_vals: torch.Tensor, weights: torch.Tensor,
                        u: torch.Tensor,
                        resample_padding: float) -> torch.Tensor:
    """Blurpool, padding and the hardened inverse CDF (kernel #9): t_vals
    [N, S+1] ascending fenceposts, weights [N, S], u [N, S+1] ASCENDING
    draws in [0, 1), the padding a host scalar; rows may be views
    (`row_stride`). Returns the new fenceposts [N, S+1]. CPU tensors take
    the plain version; CUDA tensors launch the kernel or raise."""
    n, sp1 = t_vals.shape
    if not 2 <= sp1 <= MAX_SAMPLES:
        raise ValueError(f"mip_resample_t_vals takes 2..{MAX_SAMPLES} "
                         f"fenceposts, not {sp1}")
    dev = t_vals.device
    strides = (row_stride("t_vals", t_vals, n, sp1, dev),
               row_stride("weights", weights, n, sp1 - 1, dev),
               row_stride("u", u, n, sp1, dev))
    if dev.type == "cpu":
        return plain_mip_resample_t_vals(t_vals, weights, u,
                                         resample_padding)
    if dev.type != "cuda":
        raise ValueError(f"no mip resampling kernel for device {dev}")
    out = torch.empty((n, sp1), dtype=torch.float32, device=dev)
    if n:
        mip_resample_launch(t_vals, weights, u, out, strides,
                            resample_padding,
                            torch.cuda.current_stream(dev).cuda_stream)
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
            z_vals.detach().float(), weights[..., 1:-1].detach().float(),
            u.float())
    else:
        z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
        z_samples = sampling.sample_pdf(
            z_mid, weights[..., 1:-1], n_importance, u=u, det=det
        ).detach()
        z_all, _ = torch.sort(torch.cat([z_vals, z_samples], -1), -1)
    if return_samples:
        return z_all, z_samples
    return z_all
