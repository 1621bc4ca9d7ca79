"""Metric aggregation CLI:

    python -m consistentnerf_tpu_torch.cli.metrics "logs/*"

The port of `consistentnerf_tpu/cli/metrics.py` (the reference's
`alky/calculate_metrics.py`, `RegNeRF/calculate_metrics.py`): the mean of
each metric over the experiment directories' `test_preds/metrics.txt`,
or, where a directory has none, over its `metric_{name}_{step}.txt`
files (`train/evaluation.py` writes both).
"""

from __future__ import annotations

import argparse
import glob
import os
import re
from collections import defaultdict

import numpy as np


def parse_metrics_txt(path: str) -> dict:
    """{name: value} of the `name: value` lines of a metrics.txt."""
    out = {}
    with open(path) as f:
        for line in f:
            if ":" in line:
                k, v = line.split(":", 1)
                try:
                    out[k.strip()] = float(v)
                except ValueError:
                    pass
    return out


def collect(dirs) -> dict:
    """The mean of each metric over `dirs`."""
    agg = defaultdict(list)
    for d in dirs:
        mt = os.path.join(d, "test_preds", "metrics.txt")
        if os.path.isfile(mt):
            for k, v in parse_metrics_txt(mt).items():
                agg[k].append(v)
            continue
        for f in glob.glob(os.path.join(d, "test_preds", "metric_*_*.txt")):
            m = re.match(r"metric_(.+)_(\d+)\.txt", os.path.basename(f))
            if m:
                with open(f) as fh:
                    agg[m.group(1)].append(float(fh.read().strip()))
    return {k: float(np.mean(v)) for k, v in agg.items()}


def main(argv=None):
    p = argparse.ArgumentParser(
        description="Average metrics across scene experiment dirs")
    p.add_argument("dirs", nargs="+",
                   help="experiment directories (globs ok)")
    args = p.parse_args(argv)
    dirs = []
    for d in args.dirs:
        dirs.extend(sorted(glob.glob(d)))
    result = collect(dirs)
    if not result:
        print("no metrics found")
        return result
    for k, v in sorted(result.items()):
        print(f"{k}: {v:.4f}")
    return result


if __name__ == "__main__":
    main()
