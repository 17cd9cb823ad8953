"""The recipe CLI's arguments (counterpart of desed_task_tpu/utils/cli.py).

Every reference train entry point has the same contract
(e.g. recipes/dcase2022_task4_baseline/train_sed.py:285-345):
--conf_file / --log_dir / --resume_from_checkpoint / --test_from_checkpoint /
--eval_from_checkpoint / --fast_dev_run, with --strong_real where AudioSet
strong real data is optional. yaml is imported inside train_cli only. The
run takes the card ("cuda"); a CPU run calls single_run(..., device="cpu").
"""

from __future__ import annotations

import argparse


def train_cli(description: str, default_conf: str, default_log_dir: str,
              strong_real: bool = False, argv=None):
    """Parse the shared train-CLI arguments and run single_run. Returns
    (state, test results)."""
    parser = argparse.ArgumentParser(description)
    parser.add_argument("--conf_file", default=default_conf)
    parser.add_argument("--log_dir", default=default_log_dir)
    parser.add_argument("--resume_from_checkpoint", action="store_true")
    parser.add_argument("--test_from_checkpoint", default=None,
                        help="checkpoint dir to test (no training)")
    parser.add_argument("--eval_from_checkpoint", default=None,
                        help="checkpoint dir for label-free eval score dump")
    parser.add_argument("--fast_dev_run", action="store_true")
    parser.add_argument("--no_fast_math", action="store_true",
                        help="disable the bf16 conv blocks and front-end (fp32 throughout)")
    if strong_real:
        parser.add_argument("--strong_real", action="store_true", default=False,
                            help="include the AudioSet strong annotations in training")
    args = parser.parse_args(argv)

    import yaml

    with open(args.conf_file) as f:
        config = yaml.safe_load(f)

    from ..training.single_run import single_run

    evaluation = args.eval_from_checkpoint is not None
    state, results = single_run(
        config,
        args.log_dir,
        checkpoint_resume=args.resume_from_checkpoint,
        test_from_checkpoint=args.test_from_checkpoint or args.eval_from_checkpoint,
        fast_dev_run=args.fast_dev_run,
        evaluation=evaluation,
        fast=not args.no_fast_math,
        strong_real=getattr(args, "strong_real", False),
    )
    if results is not None:
        print("==== dev-test results ====")
        for k, v in results.items():
            if isinstance(v, float):
                print(f"  {k}: {v:.4f}")
    return state, results
