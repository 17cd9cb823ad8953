"""Resample a folder of wavs (44.1 kHz -> 16 kHz typically) in worker
processes, skipping a folder already done (counterpart of
recipes/resample_folder.py; the resampler is data/audio_io.resample).

    python -m desed_task_tpu_torch.recipes.resample_folder \\
        --in_dir DIR --out_dir DIR [--target_fs 16000] [--regex '*.wav']
"""

from __future__ import annotations

import argparse
import multiprocessing
from concurrent.futures import ProcessPoolExecutor
from pathlib import Path


def _resample_one(args):
    in_path, out_path, target_fs = args
    from ..data.audio_io import read_wav, resample, to_mono, write_wav

    audio, fs = read_wav(in_path)
    audio = to_mono(audio)
    if fs != target_fs:
        audio = resample(audio, fs, target_fs)
    write_wav(out_path, audio, target_fs)
    return out_path


def resample_folder(in_dir, out_dir, target_fs=16000, regex="*.wav", workers=10):
    """Every file under in_dir matching `regex` -> out_dir/<name> at
    target_fs (mono, PCM16); returns the number written (0 when out_dir
    already holds as many matching files)."""
    in_dir, out_dir = Path(in_dir), Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    files = sorted(in_dir.rglob(regex))
    # skip-if-counts-match caching (resample_folder.py:37-59)
    if len(list(out_dir.rglob(regex))) == len(files) and files:
        print(f"{out_dir} already resampled ({len(files)} files), skipping")
        return 0
    jobs = [(str(f), str(out_dir / f.name), target_fs) for f in files]
    # spawned workers: a process that has started threads (torch's) must not fork
    ctx = multiprocessing.get_context("spawn")
    with ProcessPoolExecutor(max_workers=workers, mp_context=ctx) as pool:
        for i, _ in enumerate(pool.map(_resample_one, jobs)):
            if (i + 1) % 500 == 0:
                print(f"  {i + 1}/{len(jobs)}")
    return len(jobs)


def main(argv=None, workers: int = 10) -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--in_dir", required=True)
    parser.add_argument("--out_dir", required=True)
    parser.add_argument("--target_fs", type=int, default=16000)
    parser.add_argument("--regex", default="*.wav")
    args = parser.parse_args(argv)
    n = resample_folder(args.in_dir, args.out_dir, args.target_fs, args.regex, workers)
    print(f"resampled {n} files")
    return n


if __name__ == "__main__":
    main()
