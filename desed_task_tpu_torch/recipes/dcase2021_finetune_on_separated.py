"""Fine-tune the 2021 separation ensemble on the card: a multisrc CRNN over
separated sources blended with a frozen monaural CRNN through the learned
scalar q (counterpart of recipes/dcase2021_task4_baseline/
finetune_on_separated.py).

    python -m desed_task_tpu_torch.recipes.dcase2021_finetune_on_separated \\
        --sed_checkpoint DIR [--conf_file CONF] [--sed_model student|teacher] \\
        [--log_dir DIR] [--n_src 4] [--fast_dev_run] [--test_from_checkpoint DIR]

Needs a trained 2021 SED checkpoint directory (--sed_checkpoint, e.g.
<log_dir>/checkpoints of dcase2021_train_sed) and the separated sources of
dcase2021_run_separation (<folder>_separated/X_src{i}.wav, or explicit
data.*_folder_sep conf keys). The default conf is
recipes/dcase2021_task4_baseline/confs/sep+sed.yaml of this repository.
"""

from __future__ import annotations

import argparse
from pathlib import Path

DEFAULT_CONF = (Path(__file__).resolve().parents[2] / "recipes" / "dcase2021_task4_baseline"
                / "confs" / "sep+sed.yaml")


def main(argv=None, run_info: dict | None = None):
    """Parse the arguments and run the fine-tune; returns (state, test
    results). `run_info` goes to sepsed_single_run."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--conf_file", default=str(DEFAULT_CONF))
    parser.add_argument("--sed_checkpoint", required=True,
                        help="checkpoint dir of the trained monaural 2021 CRNN")
    parser.add_argument("--sed_model", default="student", choices=["student", "teacher"],
                        help="which branch of the SED checkpoint seeds the ensemble")
    parser.add_argument("--log_dir", default="./exp/2021_separation_ensemble")
    parser.add_argument("--n_src", type=int, default=4)
    parser.add_argument("--fast_dev_run", action="store_true")
    parser.add_argument("--test_from_checkpoint", default=None)
    args = parser.parse_args(argv)

    import yaml

    from ..training.sepsed_run import sepsed_single_run

    with open(args.conf_file) as f:
        config = yaml.safe_load(f)
    state, results = sepsed_single_run(
        config, args.log_dir, sed_checkpoint=args.sed_checkpoint, sed_model=args.sed_model,
        n_src=args.n_src, fast_dev_run=args.fast_dev_run,
        test_from_checkpoint=args.test_from_checkpoint, run_info=run_info)
    if results is not None:
        print("==== dev-test results (separation ensemble) ====")
        for k, v in results.items():
            if isinstance(v, float):
                print(f"  {k}: {v:.4f}")
    return state, results


if __name__ == "__main__":
    main()
