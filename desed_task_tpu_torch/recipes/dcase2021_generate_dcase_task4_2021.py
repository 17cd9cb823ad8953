"""DCASE 2021 dataset generation (counterpart of recipes/
dcase2021_task4_baseline/generate_dcase_task4_2021.py): the DESED real
download where the `desed` package is installed, then synthetic soundscapes
from a soundbank with SNR 6-30 dB and a -50 dB reference
(tools/soundscapes.py).

    python -m desed_task_tpu_torch.recipes.dcase2021_generate_dcase_task4_2021 \\
        --basedir DIR --soundbank DIR [--n_train 10000] [--n_val 2500] \\
        [--snr_min 6] [--snr_max 30] [--ref_db -50] [--seed 2021]
"""

from __future__ import annotations

import argparse
from pathlib import Path


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--basedir", default="../../data/dcase/dataset")
    parser.add_argument("--soundbank", default=None,
                        help="folder with foreground/<class>/*.wav + background/*.wav")
    parser.add_argument("--n_train", type=int, default=10000)
    parser.add_argument("--n_val", type=int, default=2500)
    parser.add_argument("--snr_min", type=float, default=6.0)
    parser.add_argument("--snr_max", type=float, default=30.0)
    parser.add_argument("--ref_db", type=float, default=-50.0)
    parser.add_argument("--seed", type=int, default=2021)
    args = parser.parse_args(argv)

    try:
        import desed

        desed.download_desed(args.basedir, weak=True, unlabel_in_domain=True,
                             validation=True)
    except ImportError:
        print("[real] `desed` unavailable; download DESED real data manually")

    if args.soundbank is None:
        print("[synth] pass --soundbank to generate synthetic soundscapes")
        return {}
    from ..tools.soundscapes import SoundscapeConfig, SoundscapeGenerator

    cfg = SoundscapeConfig(snr_range=(args.snr_min, args.snr_max), ref_db=args.ref_db)
    base = Path(args.basedir)
    tables = {}
    for split, n, seed_off in [("train", args.n_train, 0), ("validation", args.n_val, 1)]:
        gen = SoundscapeGenerator(
            Path(args.soundbank) / "foreground", Path(args.soundbank) / "background",
            cfg, seed=args.seed + seed_off,
        )
        out_audio = base / f"audio/{split}/synthetic21_{split}/soundscapes_16k"
        out_tsv = base / f"metadata/{split}/synthetic21_{split}/soundscapes.tsv"
        tables[split] = gen.generate(n, out_audio, out_tsv)
        print(f"[synth] {split}: {n} soundscapes -> {out_audio}")
    return tables


if __name__ == "__main__":
    main()
