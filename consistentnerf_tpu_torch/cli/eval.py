"""Eval CLI: render the test views of a trained checkpoint and score them
with the full metric suite (`RegNeRF/eval.py`, the testset branch of
`run_nerf_view.py:2034-2127`):

    python -m consistentnerf_tpu_torch.cli.eval --set dataset_type=llff \
        --set datadir=data/nerf_llff_data/fern --set compute_dtype=bfloat16

Weights come from the newest train checkpoint under
`{basedir}/{expname}/checkpoints/` (--step picks one); without one the
model is scored from its seeded init, and says so. Metrics and images go
to `{basedir}/{expname}/test_preds/`. Runs on `cuda` unless --device
says otherwise.
"""

from __future__ import annotations

import os


def main(argv=None):
    from consistentnerf_tpu_torch.cli import common

    p = common.make_parser("Evaluate a trained ConsistentNeRF model "
                           "(PyTorch port)")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default latest)")
    args = p.parse_args(argv)
    cfg = common.resolve_config(args)
    cfg = common.auto_fused_defaults(cfg, args)
    exp_dir = os.path.join(cfg.basedir, cfg.expname)

    from consistentnerf_tpu_torch.data.loaders import load_scene
    from consistentnerf_tpu_torch.models.factory import make_model
    from consistentnerf_tpu_torch.train.checkpoints import CheckpointManager
    from consistentnerf_tpu_torch.train.evaluation import evaluate

    scene = load_scene(cfg, device=args.device)
    model = make_model(cfg, args.device)
    step = CheckpointManager(os.path.join(exp_dir, "checkpoints")
                             ).restore_for_eval(model, step=args.step)
    if step is None:
        step = 0
        print("warning: no checkpoint found; evaluating random init")
    model.eval()
    metrics = evaluate(model, cfg, scene,
                       out_dir=os.path.join(exp_dir, "test_preds"),
                       step=step)
    for k, v in sorted(metrics.items()):
        print(f"{k}: {v:.4f}")
    return metrics


if __name__ == "__main__":
    main()
