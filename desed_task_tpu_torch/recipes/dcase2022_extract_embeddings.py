"""Extract frozen pretrained embeddings (BEATs, PANNs or AST) of every
split of a DCASE 2022 recipe conf into HDF5 stores on the card (counterpart
of recipes/dcase2022_task4_baseline/extract_embeddings.py).

    python -m desed_task_tpu_torch.recipes.dcase2022_extract_embeddings \\
        --conf_file CONF [--pretrained_model beats|panns|ast] \\
        [--checkpoint FILE] [--output_dir DIR] [--batch_size N]

The 2022 recipe ships no confs/pretrained.yaml (its confs are default.yaml,
pretrained_ast.yaml and pretrained_panns.yaml), so --conf_file is required.
"""

from __future__ import annotations

from ..utils.cli import extract_cli


def main(argv=None, device=None):
    return extract_cli("Extract pretrained embeddings for DCASE 2022 Task 4",
                       default_conf=None, argv=argv, device=device)


if __name__ == "__main__":
    main()
