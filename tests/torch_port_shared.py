"""What the port's test files share (`from torch_port_shared import ...`):

* `_one_torch_thread`, an autouse module fixture: one intra-op torch
  thread while the module's tests run. The suite runs several test
  processes at once, and torch's thread pool in each of them would
  oversubscribe the cores. It sets torch's threads only, never JAX's or
  XLA's.
* `once_per_run`: a JAX reference result computed once for the whole
  test run. Under pytest-xdist the cases of one file spread over the
  workers, so a module fixture would otherwise build the same JAX run on
  each worker that gets one of its cases, and again whenever a worker
  comes back to the file. The result is still computed live from the JAX
  package in each run; nothing is stored between runs.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Callable

import filelock
import pytest
import torch


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def once_per_run(request, build: Callable[[], Any]) -> Any:
    """`build()`'s result for the fixture that `request` belongs to (its
    module, name and param), computed once a run.

    Without xdist this is `build()`. Under xdist the workers share the
    run's temp root (the parent of each worker's base temp, the
    pytest-xdist pattern for session fixtures): the first worker to ask
    builds the result and pickles it there under a file lock, the others
    wait on the lock and unpickle it. The result must pickle: numpy
    arrays, torch tensors, JAX arrays, configs, not jitted functions or
    models."""
    if not os.environ.get("PYTEST_XDIST_WORKER"):
        return build()
    key = f"{request.module.__name__}.{request.fixturename}"
    if hasattr(request, "param"):
        key += f".{request.param_index}"
    root = request.getfixturevalue("tmp_path_factory").getbasetemp().parent
    path = root / f"once_per_run.{key}.pkl"
    with filelock.FileLock(f"{path}.lock"):
        if path.is_file():
            with open(path, "rb") as f:
                return pickle.load(f)
        value = build()
        with open(f"{path}.tmp", "wb") as f:
            pickle.dump(value, f)
        os.replace(f"{path}.tmp", path)
    return value
