"""The train loop's housekeeping (`train/loop.py`) and the threaded
`Prefetcher` (`data/pipeline.py`), as the JAX package has them
(`train/loop.py:113-268`, `data/pipeline.py:398-451`).

The Prefetcher is held to the JAX tests' cases (tests/test_pipeline.py:
no batch dropped under a slow consumer, the batcher's error re-raised,
StopIteration passed on) and to the batcher's own stream; every
prefetcher is closed in a `finally` and every wait has a timeout.
`train()` gives the same stats with prefetch on and off; restores `gc`
also when a step raises; collects every `gc_every` steps; writes a
Chrome trace of `profile_steps` steps, the held-out renders with their
log line, and the TensorBoard scalars; and says so in one line when it
cannot make a SummaryWriter.
"""

import gc
import json
import os
import sys
import time

import numpy as np
import pytest
import torch

from consistentnerf_tpu.configs import Config as JaxConfig
from consistentnerf_tpu.data import synthetic as jsynth
from consistentnerf_tpu.data.pipeline import VanillaBatcher as JaxBatcher
from consistentnerf_tpu_torch import configs
from consistentnerf_tpu_torch.data import synthetic
from consistentnerf_tpu_torch.data.pipeline import (Prefetcher,
                                                    VanillaBatcher)
from consistentnerf_tpu_torch.train import bootstrap, loop
from torch_port_shared import _one_torch_thread  # noqa: F401

TINY = dict(dataset_type="synthetic", netdepth=2, netwidth=32, N_samples=8,
            N_importance=8, multires=4, multires_views=2, N_rand=32,
            n_patches=1, patch_size=8, white_bkgd=True, hardmask=False,
            with_depth_loss=True, use_fused_train=True,
            use_onepass_train=True, use_tensorboard=False, gc_every=0,
            i_print=1, checkpoint_every=100)


@pytest.fixture(scope="module")
def scene():
    return synthetic.make_scene(n_views=4, H=24, W=24).to_scene_data()


class _CountingBatcher:
    """0, 1, 2, ...; raises ValueError at `fail_at`, stops at `stop_at`."""

    def __init__(self, fail_at=None, stop_at=None):
        self.i, self.fail_at, self.stop_at = 0, fail_at, stop_at

    def __iter__(self):
        return self

    def __next__(self):
        if self.stop_at is not None and self.i >= self.stop_at:
            raise StopIteration
        if self.fail_at is not None and self.i >= self.fail_at:
            raise ValueError("poisoned batcher")
        v = self.i
        self.i += 1
        return v


def test_prefetcher_never_drops_batches():
    """A slow consumer sees the exact batcher stream (the producer makes
    one batch at a time and retries a full queue)."""
    p = Prefetcher(_CountingBatcher(), depth=1)
    try:
        time.sleep(0.1)  # the producer meets a full queue
        got = []
        for _ in range(10):
            got.append(next(p))
            time.sleep(0.02)
    finally:
        p.close()
    assert got == list(range(10)), got
    assert not p.thread.is_alive()


def test_prefetcher_surfaces_the_batchers_errors():
    p = Prefetcher(_CountingBatcher(fail_at=2), depth=4)
    try:
        assert [next(p), next(p)] == [0, 1]
        with pytest.raises(RuntimeError) as ei:
            next(p)
        assert isinstance(ei.value.__cause__, ValueError)
    finally:
        p.close()
    p = Prefetcher(_CountingBatcher(stop_at=3), depth=4)
    try:
        assert [next(p) for _ in range(3)] == [0, 1, 2]
        with pytest.raises(StopIteration):
            next(p)
    finally:
        p.close()


def test_prefetcher_close_stops_the_thread():
    """close() stops a producer blocked on a full queue at once (it
    empties the queue), and the consumer then stops too."""
    p = Prefetcher(_CountingBatcher(), depth=2)
    try:
        time.sleep(0.05)
        assert p.thread.is_alive() and p.queue.full()
        t0 = time.monotonic()
    finally:
        p.close()
    assert time.monotonic() - t0 < 0.5
    assert not p.thread.is_alive()
    with pytest.raises(StopIteration):
        next(p)


def test_prefetched_stream_is_the_batchers(scene):
    """Batches through the thread equal a direct batcher's of the same
    seed, bit for bit, and the JAX batcher's."""
    cfg = configs.Config(**TINY)
    direct = VanillaBatcher(scene, cfg)
    p = Prefetcher(VanillaBatcher(scene, cfg))
    try:
        got = [next(p) for _ in range(4)]
    finally:
        p.close()
    jax_b = JaxBatcher(jsynth.make_scene(n_views=4, H=24,
                                         W=24).to_scene_data(),
                       JaxConfig(**TINY))
    for b in got:
        want = direct.next_batch()
        jwant = jax_b.next_batch()
        assert b.keys() == want.keys()
        for k in b:
            np.testing.assert_array_equal(b[k], want[k], err_msg=k)
            np.testing.assert_allclose(b[k], np.asarray(jwant[k]),
                                       atol=1e-6, err_msg=k)


def test_train_with_and_without_prefetch(scene, tmp_path):
    """The same stats history with prefetch on and off."""
    hist = []
    for pre in (True, False):
        cfg = configs.Config(**TINY, basedir=str(tmp_path),
                             expname=f"pre{pre}")
        res = loop.train(cfg, scene, num_steps=3, device="cpu",
                         use_prefetch=pre, log_fn=lambda m: None)
        hist.append(res.stats_history)
    assert len(hist[0]) == len(hist[1]) == 3
    for a, b in zip(*hist):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_gc_state_is_restored_after_a_raising_step(scene, tmp_path,
                                                   monkeypatch):
    """gc is off inside the loop and back on after it, also when a step
    raises; gc_every collects on multiples of it; the prefetcher's thread
    ends."""
    seen, threads = [], []

    def step_fn(state, batch):
        seen.append(gc.isenabled())
        if len(seen) == 3:
            raise RuntimeError("step 3 fails")
        state.step += 1
        return state, {"loss": torch.tensor(0.5)}

    real_prefetcher = loop.Prefetcher

    def spy_prefetcher(batcher):
        p = real_prefetcher(batcher)
        threads.append(p.thread)
        return p

    monkeypatch.setattr(loop, "select_train_step", lambda *a, **k: step_fn)
    monkeypatch.setattr(loop, "Prefetcher", spy_prefetcher)
    collected = []
    real_collect = gc.collect
    monkeypatch.setattr(loop.gc, "collect",
                        lambda *a: collected.append(len(seen)) or
                        real_collect(*a))
    cfg = configs.Config(**{**TINY, "gc_every": 2}, basedir=str(tmp_path))
    assert gc.isenabled()
    with pytest.raises(RuntimeError, match="step 3 fails"):
        loop.train(cfg, scene, num_steps=5, device="cpu",
                   log_fn=lambda m: None)
    assert gc.isenabled()
    assert seen == [False, False, False]
    assert collected == [1]  # before step 2's batch (step_i + 1 == 2)
    assert len(threads) == 1 and not threads[0].is_alive()


def test_profiler_renders_and_tensorboard(scene, tmp_path):
    """One run with every housekeeping field on: a Chrome trace of steps
    1-2, the held-out render of the first test view every 2 steps (its
    artifacts and log line), and the TensorBoard scalars train_*,
    train_rays_per_sec and test_*."""
    pytest.importorskip("tensorboard")
    from tensorboard.backend.event_processing.event_accumulator import \
        EventAccumulator

    cfg = configs.Config(**{**TINY, "use_tensorboard": True,
                            "profile_steps": 2, "train_render_every": 2,
                            "gc_every": 2, "eval_disable_lpips": True},
                         basedir=str(tmp_path), expname="hk")
    said = []
    res = loop.train(cfg, scene, num_steps=4, device="cpu",
                     log_fn=said.append)
    assert res.state.step == 4
    exp = tmp_path / "hk"
    traces = list((exp / "profile").glob("*.json"))
    assert len(traces) == 1
    events = json.loads(traces[0].read_text())["traceEvents"]
    assert any("aten::" in str(e.get("name", "")) for e in events)
    renders = sorted(os.listdir(exp / "train_renders"))
    assert {"color_000.png", "metric_psnr_2.txt",
            "metric_psnr_4.txt"} <= set(renders)
    lines = [m for m in said if m.startswith("  test render @ ")]
    assert [m.split(":")[0] for m in lines] == ["  test render @ 2",
                                                "  test render @ 4"]
    assert "psnr=" in lines[0]
    acc = EventAccumulator(str(exp / "runs"))
    acc.Reload()
    tags = set(acc.Tags()["scalars"])
    assert {"train_loss", "train_psnr", "train_rays_per_sec",
            "test_psnr", "test_ssim"} <= tags, tags
    assert [e.step for e in acc.Scalars("train_loss")] == [1, 2, 3, 4]
    assert [e.step for e in acc.Scalars("test_psnr")] == [2, 4]
    np.testing.assert_allclose(acc.Scalars("train_loss")[-1].value,
                               float(res.stats_history[-1]["loss"]),
                               rtol=1e-6)


def test_no_summary_writer_is_said_once(tmp_path, monkeypatch):
    """Without the tensorboard package the writer is
    None and the loop says why in one line; off, it says nothing."""
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    said = []
    cfg = configs.Config(use_tensorboard=True, basedir=str(tmp_path))
    assert loop.summary_writer(cfg, said.append) is None
    assert len(said) == 1 and said[0].startswith("use_tensorboard:")
    assert loop.summary_writer(cfg.replace(use_tensorboard=False),
                               said.append) is None
    assert len(said) == 1


def test_bootstrap_passes_use_prefetch(scene, monkeypatch):
    """bootstrap_scene_priors hands its warmup's train() use_prefetch, as
    the JAX bootstrap does."""
    got = {}

    class Stop(Exception):
        pass

    def spy(*a, **k):
        got.update(k)
        raise Stop

    monkeypatch.setattr(loop, "train", spy)
    cfg = configs.Config(**TINY)
    with pytest.raises(Stop):
        bootstrap.bootstrap_scene_priors(cfg, scene, 2, device="cpu",
                                         use_prefetch=False)
    assert got["use_prefetch"] is False
