"""MixIT-pretrain the TDCN++ separator on unlabeled in-domain audio, on the
card (counterpart of recipes/dcase2021_task4_baseline/pretrain_separation.py).

    python -m desed_task_tpu_torch.recipes.dcase2021_pretrain_separation \\
        --train_folders DIR [DIR ...] --val_folders DIR [DIR ...] --log_dir DIR \\
        [--n_src 4] [--epochs 10] [--steps_per_epoch 100] [--batch_mixtures 16] \\
        [--segment_seconds 4.0] [--lr 1e-3] [--limit_clips N]

Unsupervised MixIT on the dataset's own unlabeled folder, validated by
SI-SNRi on two-source mixtures from a held-out folder. The best checkpoint,
<log_dir>/tdcn_mixit_best.pt, is what
    python -m desed_task_tpu_torch.recipes.dcase2021_run_separation \\
        --backend torch --checkpoint <log_dir>/tdcn_mixit_best.pt --folders ...
loads.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--train_folders", nargs="+", required=True,
                   help="unlabeled wav folders (e.g. unlabel_in_domain)")
    p.add_argument("--val_folders", nargs="+", required=True,
                   help="held-out wavs paired into synthetic eval mixtures")
    p.add_argument("--log_dir", required=True)
    p.add_argument("--n_src", type=int, default=4)
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--steps_per_epoch", type=int, default=100)
    p.add_argument("--batch_mixtures", type=int, default=16)
    p.add_argument("--segment_seconds", type=float, default=4.0)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--limit_clips", type=int, default=None,
                   help="cap clips loaded per pool (smoke runs)")
    args = p.parse_args(argv)

    from ..training.separation_pretrain import MixITPretrainConfig, pretrain_separator

    cfg = MixITPretrainConfig(
        n_src=args.n_src, n_epochs=args.epochs, steps_per_epoch=args.steps_per_epoch,
        batch_mixtures=args.batch_mixtures, segment_len=int(args.segment_seconds * 16000),
        lr=args.lr)
    model, best = pretrain_separator(args.train_folders, args.val_folders, args.log_dir, cfg,
                                     limit_clips=args.limit_clips)
    print(f"[mixit] best checkpoint: {best}")
    return model, best


if __name__ == "__main__":
    main()
