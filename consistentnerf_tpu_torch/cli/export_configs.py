"""Materialize the scene-preset grid as config files on disk.

Recreates the reference's `configs_3view/ configs_6view/ configs_16view/
{scene}.txt` experiment-file interface (BASELINE.json names it) as JSON
config files loadable with `--config`:

    python -m consistentnerf_tpu_torch.cli.export_configs out/
    python -m consistentnerf_tpu_torch.cli.train --config out/configs_3view/lego.json
"""

from __future__ import annotations

import argparse
import os


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("out_dir")
    args = p.parse_args(argv)

    from consistentnerf_tpu_torch.configs import scenes

    count = 0
    for name in scenes.list_scenes():
        cfg = scenes.get_scene_config(name)
        if name.endswith("view"):
            scene_name, nview = name.rsplit("_", 1)
            subdir = f"configs_{nview}"
            fname = f"{scene_name}.json"
        else:
            variant, rest = name.split("_", 1)
            subdir = os.path.join("configs", variant)
            fname = f"{rest}.json"
        d = os.path.join(args.out_dir, subdir)
        os.makedirs(d, exist_ok=True)
        cfg.save(os.path.join(d, fname))
        count += 1
    print(f"wrote {count} config files under {args.out_dir}")


if __name__ == "__main__":
    main()
