"""Hyperparameter search of the 2024 recipe (counterpart of
recipes/dcase2024_task4_baseline/optuna_pretrained.py): training
hyperparameters or per-class median-filter windows, maximizing PSDS1 +
intersection F1 of the dev-test battery, each trial a single_run on the
card (tools/hpo.py: optuna where it imports, else a seeded random search).

    python -m desed_task_tpu_torch.recipes.dcase2024_optuna_pretrained \\
        --conf_file CONF --log_dir DIR [--n_trials 20] [--mode train|eval] \\
        [--fast_dev_run]
"""

from __future__ import annotations

import argparse


def main(argv=None, device=None):
    """Run the study; each trial trains on `device` (default "cuda": a
    process without a card raises at its first trial). Returns the best
    trial's record."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--conf_file", default="./confs/pretrained.yaml")
    parser.add_argument("--log_dir", default="./exp/hpo")
    parser.add_argument("--n_trials", type=int, default=20)
    parser.add_argument("--mode", choices=["train", "eval"], default="train")
    parser.add_argument("--fast_dev_run", action="store_true")
    args = parser.parse_args(argv)

    import yaml

    from ..tools.hpo import run_study
    from ..training.single_run import single_run

    with open(args.conf_file) as f:
        config = yaml.safe_load(f)

    trial_idx = [0]

    def objective(trial_config):
        trial_idx[0] += 1
        log_dir = f"{args.log_dir}/trial_{trial_idx[0]}"
        _, results = single_run(trial_config, log_dir, fast_dev_run=args.fast_dev_run,
                                device=device)
        # objective: PSDS1 + intersection F1 on dev-test (results of best ckpt)
        if results is None:
            return 0.0
        return results["psds1"] + results["intersection_f1_macro"]

    best = run_study(config, objective, args.n_trials, args.log_dir, mode=args.mode)
    print("best trial:", best)
    return best


if __name__ == "__main__":
    main()
