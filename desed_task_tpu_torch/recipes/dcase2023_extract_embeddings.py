"""Extract frozen pretrained embeddings (BEATs, PANNs or AST) of every
split of the DCASE 2023 recipe's conf into HDF5 stores on the card
(counterpart of recipes/dcase2023_task4_baseline/extract_embeddings.py).

    python -m desed_task_tpu_torch.recipes.dcase2023_extract_embeddings \\
        [--conf_file CONF] [--pretrained_model beats|panns|ast] \\
        [--checkpoint FILE] [--output_dir DIR] [--batch_size N]

The default conf is recipes/dcase2023_task4_baseline/confs/pretrained.yaml of this
repository; its data paths are relative to that recipe's folder.
"""

from __future__ import annotations

from pathlib import Path

from ..utils.cli import extract_cli

DEFAULT_CONF = (Path(__file__).resolve().parents[2] / "recipes" / "dcase2023_task4_baseline"
                / "confs" / "pretrained.yaml")


def main(argv=None, device=None):
    return extract_cli("Extract pretrained embeddings for DCASE 2023 Task 4",
                       default_conf=str(DEFAULT_CONF), argv=argv, device=device)


if __name__ == "__main__":
    main()
