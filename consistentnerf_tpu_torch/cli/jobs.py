"""Experiment sweep runner and watch-directory job daemon:

    python -m consistentnerf_tpu_torch.cli.jobs sweep --preset-glob "lego_*view"
    python -m consistentnerf_tpu_torch.cli.jobs watch /path/to/jobdir

The port of `consistentnerf_tpu/cli/jobs.py`. The reference's per-GPU
scene sweep scripts (`alky/jobs1.sh`, `masknerf*.sh`) become `sweep`: one
`python -m consistentnerf_tpu_torch.cli.train --scene NAME` run per preset
of `configs/scenes.py` matching the glob, with the extra arguments after
`--`. Its S3-polling daemon (`s3helper_job7_start.py:36-73`) becomes
`watch` over a local or NFS directory: a `NAME.job` file holds the train
CLI's arguments and the daemon runs it (output in `NAME.log`, the exit
code in `NAME.job.done` when it ends, stopped or not, and a job with its
`.done` file is not run again); a `NAME.stop` file stops it.
"""

from __future__ import annotations

import argparse
import fnmatch
import os
import shlex
import subprocess
import sys
import time
from typing import Callable, Optional

TRAIN = [sys.executable, "-m", "consistentnerf_tpu_torch.cli.train"]


def run_one(args_list, log_path: Optional[str] = None) -> int:
    """One train run to its end; its output appended to `log_path`."""
    cmd = TRAIN + list(args_list)
    print("+", " ".join(cmd), flush=True)
    stdout = open(log_path, "a") if log_path else None
    try:
        return subprocess.run(
            cmd, stdout=stdout,
            stderr=subprocess.STDOUT if stdout else None).returncode
    finally:
        if stdout:
            stdout.close()


def sweep(preset_glob: str, extra_args, dry_run: bool = False) -> list:
    """Train every preset matching `preset_glob`; returns their names.
    A failed run is named at the end (SystemExit)."""
    from consistentnerf_tpu_torch.configs import scenes

    names = [n for n in scenes.list_scenes()
             if fnmatch.fnmatch(n, preset_glob)]
    if not names:
        raise SystemExit(f"no presets match {preset_glob!r}")
    print(f"sweeping {len(names)} presets: {names}")
    failures = []
    for name in names:
        if dry_run:
            continue
        if run_one(["--scene", name] + list(extra_args)) != 0:
            failures.append(name)
    if failures:
        raise SystemExit(f"failed presets: {failures}")
    return names


def watch(jobdir: str, poll_s: float = 10.0,
          until: Optional[Callable[[], bool]] = None) -> None:
    """Run each `*.job` of `jobdir` as it appears, stop one on its
    `.stop` file, and write `NAME.job.done` (the exit code) when one
    ends; polls every `poll_s` seconds, forever or until `until()`."""
    os.makedirs(jobdir, exist_ok=True)
    print(f"watching {jobdir} for *.job files (stop with <name>.stop)",
          flush=True)
    running: dict = {}
    while until is None or not until():
        for f in sorted(os.listdir(jobdir)):
            path = os.path.join(jobdir, f)
            if (f.endswith(".job") and f not in running
                    and not os.path.exists(path + ".done")):
                with open(path) as fh:
                    args = shlex.split(fh.read())
                print("+ starting", f, flush=True)
                with open(path[:-len(".job")] + ".log", "w") as log:
                    running[f] = subprocess.Popen(
                        TRAIN + args, stdout=log, stderr=subprocess.STDOUT)
            if f.endswith(".stop"):
                proc = running.get(f[:-len(".stop")] + ".job")
                if proc is not None and proc.poll() is None:
                    print("+ stopping", f[:-len(".stop")] + ".job",
                          flush=True)
                    proc.terminate()
                os.remove(path)
        for name, proc in list(running.items()):
            if proc.poll() is not None:
                print(f"+ finished {name} rc={proc.returncode}", flush=True)
                with open(os.path.join(jobdir, name + ".done"), "w") as fh:
                    fh.write(str(proc.returncode))
                running.pop(name)
        time.sleep(poll_s)
    for proc in running.values():
        proc.terminate()
        proc.wait()


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)
    ps = sub.add_parser("sweep")
    ps.add_argument("--preset-glob", required=True)
    ps.add_argument("--dry-run", action="store_true")
    ps.add_argument("extra", nargs="*",
                    help="extra args passed to every train run")
    pw = sub.add_parser("watch")
    pw.add_argument("jobdir")
    pw.add_argument("--poll", type=float, default=10.0)
    args = p.parse_args(argv)
    if args.cmd == "sweep":
        return sweep(args.preset_glob, args.extra, args.dry_run)
    return watch(args.jobdir, args.poll)


if __name__ == "__main__":
    main()
