"""Streaming HTTP download and the missing-file bookkeeping of the dataset
scripts (counterpart of desed_task_tpu/tools/download.py; tables are column
tables, utils/table.py). Gated: a failed download raises a clear error."""

from __future__ import annotations

from pathlib import Path

import numpy as np

from ..utils import table as tbl


def download_from_url(url: str, destination, chunk_size: int = 1 << 20) -> str:
    import requests

    destination = Path(destination)
    destination.parent.mkdir(parents=True, exist_ok=True)
    try:
        with requests.get(url, stream=True, timeout=30) as r:
            r.raise_for_status()
            total = int(r.headers.get("content-length", 0))
            done = 0
            with open(destination, "wb") as f:
                for chunk in r.iter_content(chunk_size=chunk_size):
                    f.write(chunk)
                    done += len(chunk)
                    if total:
                        print(f"\r{destination.name}: {done/total:6.1%}", end="")
            print()
    except requests.RequestException as e:
        raise RuntimeError(
            f"download of {url} failed ({e}); this environment may have no "
            "network egress — fetch the file manually"
        ) from e
    return str(destination)


def audit_missing_files(meta_tsv, audio_folder, out_tsv) -> dict:
    """Record metadata clips absent from disk to a recovery tsv.

    Parity with the reference's missing-file bookkeeping after YouTube-sourced
    downloads (generate_dcase_task4_2024.py:183-222 /
    desed.download_audioset_files_from_csv missing_files_tsv): clips listed in
    `meta_tsv` but with no wav in `audio_folder` are written to `out_tsv`
    (the metadata's rows, one per clip, deduplicated, original order) so the
    user can re-download or send the list to the task organisers. Returns
    the missing rows as a table; writes nothing when nothing is missing.
    """
    table = tbl.read_tsv(meta_tsv)
    cols = tbl.columns(table)
    col = "filename" if "filename" in cols else cols[0]
    present = {p.name for p in Path(audio_folder).glob("*.wav")}
    seen, rows = set(), []
    for i, v in enumerate(tbl.column(table, col)):
        if Path(str(v)).name not in present and v not in seen:
            seen.add(v)
            rows.append(i)
    missing = tbl.take(table, rows)
    if rows:
        out = Path(out_tsv)
        out.parent.mkdir(parents=True, exist_ok=True)
        tbl.write_tsv(out, missing)
    return missing


def generate_tsv_wav_durations(audio_dir, out_tsv) -> dict:
    """Write a filename/duration tsv for a folder of wavs (parity with
    recipes/*/local/utils.py generate_tsv_wav_durations :204), from the
    decoded sample count (data/audio_io.read_wav)."""
    from ..data.audio_io import read_wav

    names, durs = [], []
    for wav in sorted(Path(audio_dir).glob("*.wav")):
        audio, rate = read_wav(wav)
        names.append(wav.name)
        durs.append(audio.shape[-1] / rate)
    table = {"filename": np.asarray(names, object), "duration": np.asarray(durs, np.float64)}
    Path(out_tsv).parent.mkdir(parents=True, exist_ok=True)
    tbl.write_tsv(out_tsv, table)
    return table
