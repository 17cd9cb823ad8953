"""Re-render synthetic soundscape subsets from the generator's stored
per-soundscape metadata (counterpart of recipes/dcase2021_task4_baseline/
generate_dcase_subset.py): non-target SNRs decreased (--db_decrease),
non-target events dropped (--drop_nontarget), and/or the background removed
(--no_background). Event tables are the originals' up to dropped rows; only
gains change.

    python -m desed_task_tpu_torch.recipes.dcase2021_generate_dcase_subset \\
        --meta_folder DIR --soundbank DIR --out_audio DIR --out_tsv FILE \\
        [--db_decrease DB] [--target_class C ...] [--drop_nontarget] \\
        [--no_background]
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--meta_folder", required=True,
                        help="folder with the generator's *.json metadata")
    parser.add_argument("--soundbank", required=True)
    parser.add_argument("--out_audio", required=True)
    parser.add_argument("--out_tsv", required=True)
    parser.add_argument("--db_decrease", type=float, default=0.0,
                        help="dB to subtract from non-target event SNRs")
    parser.add_argument("--target_class", action="append", default=None,
                        help="target class(es); repeatable")
    parser.add_argument("--drop_nontarget", action="store_true",
                        help="remove non-target events instead of attenuating")
    parser.add_argument("--no_background", action="store_true")
    args = parser.parse_args(argv)

    from ..tools.soundscapes import SoundscapeConfig, rerender_subset
    from ..utils import table as tbl

    fg = Path(args.soundbank) / "foreground"
    bg = None if args.no_background else Path(args.soundbank) / "background"
    table = rerender_subset(
        args.meta_folder, fg, bg, args.out_audio, args.out_tsv,
        cfg=SoundscapeConfig(),
        db_decrease=args.db_decrease,
        target_labels=args.target_class,
        drop_nontarget=args.drop_nontarget,
        keep_background=not args.no_background,
    )
    n_files = len(set(table["filename"]))
    print(f"re-rendered {n_files} soundscapes "
          f"({tbl.n_rows(tbl.dropna(table))} events) -> {args.out_audio}")
    return table


if __name__ == "__main__":
    main()
