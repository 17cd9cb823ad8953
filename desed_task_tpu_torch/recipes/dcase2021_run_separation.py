"""Separate every wav of dataset folders into sources, the 2021 recipe's
preprocessing (counterpart of recipes/dcase2021_task4_baseline/
run_separation.py).

    python -m desed_task_tpu_torch.recipes.dcase2021_run_separation \\
        --folders DIR [DIR ...] [--backend tf1|torch] [--checkpoint PATH] \\
        [--metagraph PATH] [--out_suffix _separated]

--backend torch (the default): the TDCN++ on the card, weights from
dcase2021_pretrain_separation's checkpoint (random from a seed without
one). --backend tf1: Google's MixIT metagraph on the host, the reference's
default; it needs the downloaded --checkpoint and --metagraph. Each folder's sources go to <folder><out_suffix>/X_src{i}.wav.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--backend", choices=["tf1", "torch"], default="torch",
                        help="tf1 = Google's frozen MixIT metagraph; "
                             "torch = the TDCN++ of models/tdcn.py on the card")
    parser.add_argument("--checkpoint", default=None,
                        help="TF1 checkpoint prefix, or the torch backend's checkpoint")
    parser.add_argument("--metagraph", default=None,
                        help="path to inference.meta (tf1 backend)")
    parser.add_argument("--folders", nargs="+", required=True, help="wav folders to separate")
    parser.add_argument("--out_suffix", default="_separated")
    args = parser.parse_args(argv)

    from ..tools.separation import SeparationModel, TorchSeparationModel

    if args.backend == "torch":
        model = TorchSeparationModel(args.checkpoint)
    else:
        if not (args.checkpoint and args.metagraph):
            parser.error("the tf1 backend needs --checkpoint and --metagraph")
        model = SeparationModel(args.checkpoint, args.metagraph)
    counts = {}
    for folder in args.folders:
        out = folder.rstrip("/") + args.out_suffix
        counts[folder] = model.separate_folder(folder, out)
        print(f"separated {counts[folder]} files: {folder} -> {out}")
    return counts


if __name__ == "__main__":
    main()
