"""DCASE 2024 dataset acquisition & preparation (counterpart of
recipes/dcase2024_task4_baseline/generate_dcase_task4_2024.py, itself after
the reference generate_dcase_task4_2024.py:27-222):

  1. DESED real (weak/unlabeled/validation) + AudioSet-strong via the
     `desed` package (downloads gated on availability / network),
  2. synthetic soundscapes (downloaded zip, or generated locally from a
     soundbank via tools/soundscapes.py),
  3. MAESTRO long-form download + windowing into 10 s chunks
     (data/maestro_prep.py).

Stages run independently; missing optional dependencies (desed, network)
produce actionable messages instead of crashes.

    python -m desed_task_tpu_torch.recipes.dcase2024_generate_dcase_task4_2024 \\
        [--basedir DIR] [--soundbank DIR] [--maestro_dir DIR] \\
        [--n_soundscapes N] [--stage all|real|strong|synth|maestro|audit ...]
"""

from __future__ import annotations

import argparse
from pathlib import Path


def stage_desed_real(basedir):
    try:
        import desed  # noqa
    except ImportError:
        print(
            "[desed-real] the `desed` package is not installed; download the "
            "DESED real data (weak/unlabeled/validation) manually from "
            "Zenodo/YouTube per the DCASE Task 4 instructions into "
            f"{basedir}/audio/train and {basedir}/audio/validation"
        )
        return
    import desed

    desed.download_desed(basedir, weak=True, unlabel_in_domain=True, validation=True)
    print("[desed-real] done")


def stage_audioset_strong(basedir):
    try:
        import desed
    except ImportError:
        print(
            "[audioset-strong] `desed` unavailable; fetch audioset_strong.tsv "
            "and the strong-label clips manually (missing files are recorded "
            "to a tsv for recovery, as the reference does)"
        )
        return
    import desed

    desed.download_audioset_data(basedir)
    print("[audioset-strong] done")


def stage_synth(basedir, soundbank=None, n_soundscapes=10000):
    out_audio = Path(basedir) / "dcase_synth/audio/train/synthetic21_train/soundscapes_16k"
    out_tsv = Path(basedir) / "dcase_synth/metadata/train/synthetic21_train/soundscapes.tsv"
    if out_tsv.exists():
        print("[synth] already prepared, skipping")
        return
    if soundbank is None:
        print(
            "[synth] no --soundbank given; either download the pre-generated "
            "synthetic set (zenodo) or pass a soundbank folder with "
            "foreground/<class>/*.wav and background/*.wav to synthesize "
            "locally (scaper-equivalent generator)"
        )
        return
    from ..tools.soundscapes import SoundscapeGenerator

    gen = SoundscapeGenerator(
        Path(soundbank) / "foreground", Path(soundbank) / "background"
    )
    gen.generate(n_soundscapes, out_audio, out_tsv)
    print(f"[synth] generated {n_soundscapes} soundscapes")


def stage_maestro(maestro_dir, basedir):
    maestro_dir = Path(maestro_dir) if maestro_dir else None
    if maestro_dir is None or not maestro_dir.exists():
        print(
            "[maestro] pass --maestro_dir pointing at the downloaded MAESTRO "
            "development data (development_audio/ + development_annotation/)"
        )
        return
    from ..data.maestro_prep import prepare_maestro_folder
    from ..utils.table import write_tsv

    audio = sorted((maestro_dir / "development_audio").rglob("*.wav"))
    anns = sorted((maestro_dir / "development_annotation").rglob("*.txt"))
    out_audio = Path(basedir) / "audio/maestro_real_train_16k"
    tsv = prepare_maestro_folder(audio, anns, out_audio, window_len=10, hop_len=1)
    meta = Path(basedir) / "metadata"
    meta.mkdir(parents=True, exist_ok=True)
    write_tsv(meta / "maestro_real_train.tsv", tsv)
    print(f"[maestro] {len(audio)} files windowed -> {out_audio}")


def stage_audit(basedir):
    """Missing-file bookkeeping (reference generate_dcase_task4_2024.py:183-222):
    for every YouTube-sourced subset with metadata on disk, write
    missing_files/missing_files_<subset>.tsv listing clips the download did
    not fetch, and print the reference's recovery instructions."""
    from ..tools.download import audit_missing_files
    from ..utils.table import n_rows

    base = Path(basedir)
    subsets = {
        "weak": ("metadata/train/weak.tsv", "audio/train/weak"),
        "unlabel_in_domain": (
            "metadata/train/unlabel_in_domain.tsv", "audio/train/unlabel_in_domain",
        ),
        "validation": ("metadata/validation/validation.tsv", "audio/validation"),
        "strong_label_real": (
            "metadata/train/audioset_strong.tsv", "audio/train/strong_label_real",
        ),
    }
    any_missing = False
    for name, (meta, audio) in subsets.items():
        meta_path, audio_path = base / meta, base / audio
        if not meta_path.exists():
            continue
        out = Path("missing_files") / f"missing_files_{name}.tsv"
        missing = audit_missing_files(meta_path, audio_path, out)
        if n_rows(missing):
            any_missing = True
            print(f"[audit] {name}: {n_rows(missing)} missing clips -> {out}")
    if any_missing:
        print(
            "[audit] you have missing files; retry the download "
            "(desed.download_audioset_data) or send the missing_files_*.tsv "
            "to the task organisers to obtain them"
        )
    else:
        print("[audit] no missing files")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--basedir", default="../../data/dcase/dataset")
    parser.add_argument("--soundbank", default=None)
    parser.add_argument("--maestro_dir", default=None)
    parser.add_argument("--n_soundscapes", type=int, default=10000)
    parser.add_argument("--stage", nargs="*", default=["all"],
                        choices=["all", "real", "strong", "synth", "maestro", "audit"])
    args = parser.parse_args(argv)
    stages = set(args.stage)
    run_all = "all" in stages
    if run_all or "real" in stages:
        stage_desed_real(args.basedir)
    if run_all or "strong" in stages:
        stage_audioset_strong(args.basedir)
    if run_all or "synth" in stages:
        stage_synth(args.basedir, args.soundbank, args.n_soundscapes)
    if run_all or "maestro" in stages:
        stage_maestro(args.maestro_dir, args.basedir)
    if run_all or "audit" in stages:
        stage_audit(args.basedir)


if __name__ == "__main__":
    main()
