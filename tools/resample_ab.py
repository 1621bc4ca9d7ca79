#!/usr/bin/env python3
"""Device time of the resampling kernels #8 (`csrc/pdf_merge.cu`) and #9
(`csrc/mip_resample.cu`) at a render chunk's rows, for the same launches
with the arithmetic cut out, and, optionally, for an earlier tree's
build of both:

    python3 tools/resample_ab.py [--parent-csrc DIR]

Builds both sources as shipped and from a copy patched to load each
ray's rows and store rows of the outputs' sizes with no arithmetic
between (`loads_stores_only`: the floor of the launch's memory pattern),
under `build/resample_ab/`. `--parent-csrc DIR` builds another tree's
`csrc` whose C entries take contiguous rows and no strides (the sources
before the strided entries) into `build/resample_ab/parent/`. Times one
launch of each build with `chip_smoke.launch_device_ms` (torch.profiler,
the L2 flushed before each launch) on 8192 rays: #8 with 64 coarse
depths and 128 deterministic draws, #9 with 97 fenceposts, both with
seeded peaked weights. The builds take turns, forwards and then
backwards, twice. The parent's outputs are held against the shipped
build's (max |diff|: the order of the sums differs). Prints the card's
name and power limit beside the times.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

N_RAYS = 8192
S_C, S_I, S_MIP = 64, 128, 96
VARIANTS = ("shipped", "loads_stores_only")
# Where the loads-only copies return: after each ray's loads, before the
# arithmetic; each lane stores what it loaded into rows of the outputs'
# sizes.
COPY_AT = {
    "pdf_merge.cu": ("  // pdf_k = (w_k + 1e-5) / sum", """\
  __syncwarp();
  if (valid) {
    for (int k = sub; k < s_c + s_i; k += G)
      merged[r * (s_c + s_i) + k] = k < s_c ? z[k] : 0.f;
    for (int e = 0; e < kE; ++e)
      if (e < d_n && j0 + e < s_i) zs_out[r * s_i + j0 + e] = x[e] + c[e];
  }
  return;
"""),
    "mip_resample.cu": ("  // Blur: lane-held weights", """\
  __syncwarp();
  if (valid)
    for (int e = 0; e < kE; ++e) {
      const int j = sub + G * e;
      if (j <= s) out[r * (s + 1) + j] = x[e] + tv[j] + wv[e];
    }
  return;
"""),
}


def loads_stores_only(csrc: Path, dst: Path) -> Path:
    """A copy of `csrc` whose #8 and #9 return after their loads."""
    dst.mkdir(parents=True, exist_ok=True)
    for header in csrc.glob("*.cuh"):
        (dst / header.name).write_text(header.read_text())
    for name, (anchor, body) in COPY_AT.items():
        src = (csrc / name).read_text()
        if anchor not in src:
            raise RuntimeError(f"{name}: no '{anchor.strip()}' to cut at")
        (dst / name).write_text(src.replace(anchor, body + anchor, 1))
    return dst


def parent_kernels(csrc, build_dir):
    """#8 and #9 built from another tree's `csrc` directory (C entries
    without row strides) into `build_dir`, as {kernel: fn(*op inputs)}
    launching on the current stream with the outputs allocated as the ops
    do."""
    import torch

    from consistentnerf_tpu_torch.ops import _build, pdf_merge

    saved = (_build.CSRC, _build.BUILD_DIR)
    _build.CSRC, _build.BUILD_DIR = Path(csrc).resolve(), build_dir
    try:
        paths = _build.build_all([pdf_merge.KERNEL, pdf_merge.MIP_KERNEL])
    finally:
        _build.CSRC, _build.BUILD_DIR = saved
    pdf = ctypes.CDLL(str(paths[0])).pdf_merge
    pdf.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    mip = ctypes.CDLL(str(paths[1])).mip_resample
    mip.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_float, ctypes.c_void_p]

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def run_pdf(z_c, w, u):
        n, s_c = z_c.shape
        merged = torch.empty(n, s_c + u.shape[1], device=z_c.device)
        z_s = torch.empty_like(u)
        assert pdf(z_c.data_ptr(), w.data_ptr(), u.data_ptr(),
                   merged.data_ptr(), z_s.data_ptr(), n, s_c, u.shape[1],
                   stream()) == 0, "the parent's pdf_merge did not launch"
        return merged, z_s

    def run_mip(t, w, u, padding):
        out = torch.empty_like(t)
        assert mip(t.data_ptr(), w.data_ptr(), u.data_ptr(), out.data_ptr(),
                   t.shape[0], t.shape[1] - 1, float(padding),
                   stream()) == 0, "the parent's mip_resample did not launch"
        return out

    return {pdf_merge.KERNEL: run_pdf, pdf_merge.MIP_KERNEL: run_mip}


def peaked(n, k, gen):
    """Weights [n, k]: one Gaussian bump a ray over a floor, as a coarse
    level's compositing weights look."""
    import torch

    mu = torch.rand(n, 1, generator=gen) * k * 0.8 + k * 0.1
    sig = torch.rand(n, 1, generator=gen) * 4 + 1
    idx = torch.arange(k, dtype=torch.float32)
    return (torch.exp(-((idx - mu) / sig) ** 2)
            + 0.01 * torch.rand(n, k, generator=gen))


def main() -> None:
    import torch

    from consistentnerf_tpu_torch.ops import _build, pdf_merge

    if not torch.cuda.is_available():
        sys.exit("resample_ab: needs a CUDA device")
    chip_smoke.torch = torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    card = smi.splitlines()[0] if smi else torch.cuda.get_device_name(0)
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    n = N_RAYS
    z_c = torch.linspace(2.0, 6.0, S_C).expand(n, S_C).contiguous().to(dev)
    w8 = peaked(n, S_C - 2, gen).to(dev)
    u8 = torch.linspace(0.0, 1.0, S_I).expand(n, S_I).contiguous().to(dev)
    t9 = torch.linspace(2.0, 6.0, S_MIP + 1).expand(
        n, S_MIP + 1).contiguous().to(dev)
    w9 = peaked(n, S_MIP, gen).to(dev)
    u9 = torch.linspace(0.0, 1.0 - 2 ** -23, S_MIP + 1).expand(
        n, S_MIP + 1).contiguous().to(dev)

    runs = {}
    base = (_build.BUILD_DIR, _build.CSRC)
    for name in VARIANTS:
        _build.BUILD_DIR = REPO / "build" / "resample_ab" / name
        _build.CSRC = base[1] if name == "shipped" else \
            loads_stores_only(base[1], _build.BUILD_DIR / "csrc")
        paths = _build.build_all([pdf_merge.KERNEL, pdf_merge.MIP_KERNEL])
        for kernel in (pdf_merge.KERNEL, pdf_merge.MIP_KERNEL):
            chip_smoke.ptxas_report(_build, kernel)
        pdf = ctypes.CDLL(str(paths[0])).pdf_merge
        pdf.argtypes = [pdf_merge._CTYPES[k] for k in pdf_merge.PDF_ARGS]
        mip = ctypes.CDLL(str(paths[1])).mip_resample
        mip.argtypes = [pdf_merge._CTYPES[k] for k in pdf_merge.MIP_ARGS]

        def run8(pdf=pdf):
            merged = torch.empty(n, S_C + S_I, device=dev)
            z_s = torch.empty(n, S_I, device=dev)
            assert pdf(z_c.data_ptr(), S_C, w8.data_ptr(), S_C - 2,
                       u8.data_ptr(), S_I, merged.data_ptr(),
                       z_s.data_ptr(), n, S_C, S_I,
                       torch.cuda.current_stream().cuda_stream) == 0
            return merged, z_s

        def run9(mip=mip):
            out = torch.empty(n, S_MIP + 1, device=dev)
            assert mip(t9.data_ptr(), S_MIP + 1, w9.data_ptr(), S_MIP,
                       u9.data_ptr(), S_MIP + 1, out.data_ptr(), n, S_MIP,
                       0.01, torch.cuda.current_stream().cuda_stream) == 0
            return out

        runs[name] = {pdf_merge.KERNEL: run8, pdf_merge.MIP_KERNEL: run9}
    _build.BUILD_DIR, _build.CSRC = base
    if "--parent-csrc" in sys.argv[1:]:
        parent = parent_kernels(
            sys.argv[sys.argv.index("--parent-csrc") + 1],
            REPO / "build" / "resample_ab" / "parent")
        runs["parent"] = {
            pdf_merge.KERNEL: lambda: parent[pdf_merge.KERNEL](z_c, w8, u8),
            pdf_merge.MIP_KERNEL: lambda: parent[pdf_merge.MIP_KERNEL](
                t9, w9, u9, 0.01)}

    for kernel in (pdf_merge.KERNEL, pdf_merge.MIP_KERNEL):
        want = runs["shipped"][kernel]()
        if "parent" in runs:
            got = runs["parent"][kernel]()
            got = got if isinstance(got, tuple) else (got,)
            want_t = want if isinstance(want, tuple) else (want,)
            diff = max((a - b).abs().max().item()
                       for a, b in zip(got, want_t))
            chip_smoke.log(f"{kernel} parent vs shipped: max|diff| "
                           f"{diff:.3e}")
        times = {name: [] for name in runs}
        order = list(runs) + list(runs)[::-1]
        for name in order + order:
            times[name].append(chip_smoke.launch_device_ms(
                runs[name][kernel], f"{kernel}_kernel"))
        for name, t in times.items():
            chip_smoke.log(
                f"[{card}] {kernel} ({n} rays): {name}: device time a "
                f"launch (L2 flushed) "
                + " / ".join(chip_smoke.us_text(x) for x in t) + " us")
    if chip_smoke.GATE_FAILURES:
        sys.exit(f"resample_ab: {chip_smoke.GATE_FAILURES}")


if __name__ == "__main__":
    main()
