"""DCASE 2023 Task 4 dataset acquisition and layout (counterpart of
recipes/dcase2023_task4_baseline/generate_dcase_task4_2023.py): DESED real,
AudioSet strong and the pre-generated synthetic soundscapes, symlinked into
the dataset layout, with missing-download bookkeeping
(tools/dataset_setup.py; each stage says what to fetch by hand where the
`desed` package or the network is missing).

    python -m desed_task_tpu_torch.recipes.dcase2023_generate_dcase_task4_2023 \\
        [--basedir DIR] [--out_dir DIR] [--only_real] [--only_synth] [--only_strong]
"""

from __future__ import annotations

import argparse
import time


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--basedir", default="../../data",
                        help="base data folder for the datasets")
    parser.add_argument("--out_dir", default=None,
                        help="output folder for the assembled 2023 dataset")
    parser.add_argument("--only_real", action="store_true")
    parser.add_argument("--only_synth", action="store_true")
    parser.add_argument("--only_strong", action="store_true")
    args = parser.parse_args(argv)

    from ..tools.dataset_setup import generate_dcase_staged

    t = time.time()
    folder = generate_dcase_staged(
        args.basedir, args.out_dir,
        only_real=args.only_real,
        only_synth=args.only_synth,
        only_strong=args.only_strong,
    )
    print(f"done in {time.time() - t:.1f} s")
    return folder


if __name__ == "__main__":
    main()
