"""Staged DCASE Task 4 dataset acquisition & layout (2021-2023 generate
scripts; reference recipes/dcase202{2,3}_task4_baseline/
generate_dcase_task4_202{2,3}.py:1-211 — the two are identical up to the
year string, so both repo CLIs share this module).

Three independent stages, each gated on what is actually available:

  real    — DESED real (weak / unlabeled / validation) via the `desed`
            package (YouTube downloads). Missing clips are recorded to
            missing_files/missing_files_desed_real.tsv so users can request
            them from the organisers (reference :155-160, 205-211).
  strong  — AudioSet strong-label subset: the annotation tsv from zenodo +
            the referenced clips, with missing files recorded to
            missing_files/missing_files_strong_label_real.tsv.
  synth   — pre-generated synthetic soundscapes zip; after download the
            archive's audio/metadata trees are SYMLINKED into the dataset
            layout (link_synth_tree below — pure filesystem, works offline).

Zero-egress environments get actionable messages instead of crashes.

Counterpart of desed_task_tpu/tools/dataset_setup.py; missing-file lists
are written from column tables (utils/table.py).
"""

from __future__ import annotations

import warnings
from pathlib import Path

SYNTH_URL = "https://zenodo.org/record/6026841/files/dcase_synth.zip?download=1"
STRONG_TSV_URL = (
    "https://zenodo.org/record/6444477/files/audioset_strong.tsv?download=1"
)


def link_synth_tree(synth_root, dest_root) -> int:
    """Symlink a downloaded `dcase_synth` tree into the dataset layout.

    audio/<split>/<subfolder> -> dest/audio/<split>/<subfolder>
    metadata/<split>/synthetic21_<split>/*.tsv -> same relative path.
    Handles the flat-validation layout (audio/validation directly, no
    subfolders) the 2021 archives use. Existing destinations are left in
    place with a warning. Returns the number of links created.
    """
    synth_root, dest_root = Path(synth_root), Path(dest_root)
    created = 0

    def link(src: Path, dest: Path):
        nonlocal created
        if dest.exists() or dest.is_symlink():
            warnings.warn(f"symlink target already exists, skipping: {dest}")
            return
        dest.parent.mkdir(parents=True, exist_ok=True)
        dest.symlink_to(src.resolve())
        created += 1

    splits = ["train", "validation"]
    if (synth_root / "audio" / "eval").exists():
        splits.append("eval")
    for split in splits:
        split_audio = synth_root / "audio" / split
        subdirs = [d for d in split_audio.iterdir() if d.is_dir()] if split_audio.exists() else []
        if split == "validation" and not subdirs and (synth_root / "audio" / "validation").exists():
            # flat layout: audio/validation holds the wavs directly
            link(synth_root / "audio" / "validation",
                 dest_root / "audio" / "validation")
        else:
            for sub in subdirs:
                link(sub, dest_root / "audio" / split / sub.name)
        meta_dir = synth_root / "metadata" / split / f"synthetic21_{split}"
        if meta_dir.exists():
            for tsv in sorted(meta_dir.glob("*.tsv")):
                link(tsv, dest_root / "metadata" / split /
                     f"synthetic21_{split}" / tsv.name)
    return created


def stage_real(dataset_folder: str) -> None:
    try:
        import desed
    except ImportError:
        print(
            "[real] the `desed` package is unavailable (zero-egress image); "
            "download the DESED real data (weak / unlabeled / validation) "
            f"per the DCASE Task 4 instructions into {dataset_folder}"
        )
        return
    missing = desed.download_audioset_data(dataset_folder, n_jobs=3, chunk_size=10)
    if missing:
        record_missing_files(missing, "desed_real")
        warnings.warn(
            "some DESED real clips could not be downloaded; the list was "
            "saved under missing_files/ — send it to the task organisers "
            "to obtain the missing clips"
        )


def stage_strong(dataset_folder: str) -> None:
    tsv_path = Path(dataset_folder) / "metadata" / "train" / "audioset_strong.tsv"
    if tsv_path.is_file():
        print(f"[strong] {tsv_path} already exists, skipping download")
        return
    try:
        import desed
    except ImportError:
        print(
            "[strong] `desed` unavailable; fetch audioset_strong.tsv "
            f"({STRONG_TSV_URL}) and the referenced clips manually"
        )
        return
    desed.utils.download_file_from_url(STRONG_TSV_URL, str(tsv_path))
    missing_dir = Path("missing_files")
    missing_dir.mkdir(exist_ok=True)
    desed.download.download_audioset_files_from_csv(
        str(tsv_path),
        str(Path(dataset_folder) / "audio" / "train" / "strong_label_real"),
        missing_files_tsv=str(missing_dir / "missing_files_strong_label_real.tsv"),
    )


def stage_synth(dataset_folder: str, basedir: str) -> None:
    try:
        import desed
    except ImportError:
        print(
            f"[synth] `desed` unavailable; download {SYNTH_URL}, unpack it, "
            "and lay it out with desed_task_tpu_torch.tools.dataset_setup."
            "link_synth_tree (or generate locally with tools/soundscapes.py)"
        )
        return
    desed.download.download_and_unpack_archive(
        SYNTH_URL, dataset_folder, archive_format="zip"
    )
    synth_folder = Path(basedir) / "dcase" / "dataset" / "dcase_synth"
    n = link_synth_tree(synth_folder, dataset_folder)
    print(f"[synth] created {n} symlinks into {dataset_folder}")


def record_missing_files(missing, tag: str) -> Path:
    """Persist a list or table (a DataFrame too) of undownloadable clips
    (reference missing_files bookkeeping,
    generate_dcase_task4_2024.py:183-222)."""
    import numpy as np

    from ..utils import table as tbl

    out_dir = Path("missing_files")
    out_dir.mkdir(exist_ok=True)
    out = out_dir / f"missing_files_{tag}.tsv"
    if isinstance(missing, dict) or hasattr(missing, "columns"):
        table = tbl.as_columns(missing)
    else:
        table = {"filename": np.asarray(list(missing), dtype=object)}
    tbl.write_tsv(out, table)
    return out


def generate_dcase_staged(
    basedir: str,
    out_dir: str | None = None,
    only_real: bool = False,
    only_synth: bool = False,
    only_strong: bool = False,
) -> str:
    """Run the selected stages (all when no `only_*` flag is set)."""
    dataset_folder = out_dir or str(Path(basedir) / "dcase" / "dataset")
    run_all = not (only_real or only_synth or only_strong)
    if run_all or only_real:
        stage_real(dataset_folder)
    if run_all or only_strong:
        stage_strong(dataset_folder)
    if run_all or only_synth:
        stage_synth(dataset_folder, basedir)
    print(f"dataset layout at: {dataset_folder}")
    return dataset_folder
