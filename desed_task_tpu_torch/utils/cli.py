"""The recipe CLI's arguments (counterpart of desed_task_tpu/utils/cli.py).

Every reference train entry point has the same contract
(e.g. recipes/dcase2022_task4_baseline/train_sed.py:285-345):
--conf_file / --log_dir / --resume_from_checkpoint / --test_from_checkpoint /
--eval_from_checkpoint / --fast_dev_run, with --strong_real where AudioSet
strong real data is optional. yaml is imported inside train_cli only. The
run takes the card ("cuda"); a CPU run calls single_run(..., device="cpu").
Under `torchrun --nproc_per_node=N -m desed_task_tpu_torch.recipes.<name>`
the run is data-parallel over N cards, each rank on cuda:LOCAL_RANK
(training/single_run.py); the first rank alone prints the results.

`extract_cli` is the embedding extraction's contract (the identical
recipes/dcase202{2,3,4}_task4_baseline/extract_embeddings.py): --conf_file,
--pretrained_model beats|panns|ast (default beats), --checkpoint,
--output_dir, --batch_size; every split folder of the conf that exists is
extracted (tools/embeddings.extract_splits).
"""

from __future__ import annotations

import argparse
from pathlib import Path

# the splits extract_cli writes, and the conf's data key of each one's folder
EXTRACT_SPLITS = (("synth_train", "synth_folder"), ("strong_train", "strong_folder"),
                  ("weak_train", "weak_folder"), ("unlabeled_train", "unlabeled_folder"),
                  ("maestro_real_train", "real_maestro_train_folder"),
                  ("maestro_real_val", "real_maestro_val_folder"),
                  ("synth_val", "synth_val_folder"), ("devtest", "test_folder"),
                  ("eval", "eval_folder"))


def train_cli(description: str, default_conf: str, default_log_dir: str,
              strong_real: bool = False, argv=None, run_info: dict | None = None):
    """Parse the shared train-CLI arguments and run single_run. Returns
    (state, test results). `run_info` goes to single_run."""
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
        run_info=run_info,
    )
    if results is not None:
        print("==== dev-test results ====")
        for k, v in results.items():
            if isinstance(v, float):
                print(f"  {k}: {v:.4f}")
    return state, results


def extract_cli(description: str, default_conf: str | None, argv=None, device=None) -> dict:
    """Parse the extraction CLI's arguments and extract every split folder
    of the conf that exists, on `device` (default "cuda"). With
    `default_conf` None, --conf_file is required. Returns {split: store}."""
    parser = argparse.ArgumentParser(description)
    parser.add_argument("--conf_file", default=default_conf, required=default_conf is None)
    parser.add_argument("--pretrained_model", default="beats", choices=["beats", "panns", "ast"])
    parser.add_argument("--checkpoint", default=None,
                        help="the embedder's torch checkpoint (default: seeded random weights)")
    parser.add_argument("--output_dir", default="./embeddings")
    parser.add_argument("--batch_size", type=int, default=32)
    args = parser.parse_args(argv)

    import yaml

    with open(args.conf_file) as f:
        data = yaml.safe_load(f)["data"]
    splits = {split: data.get(key) for split, key in EXTRACT_SPLITS}
    splits = {k: v for k, v in splits.items() if v and Path(v).exists()}

    from ..tools.embeddings import extract_splits

    return extract_splits(args.pretrained_model, args.checkpoint, splits, args.output_dir,
                          fs=data["fs"], audio_len=data["audio_max_len"],
                          batch_size=args.batch_size, device=device)
