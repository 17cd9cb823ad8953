"""The port has a counterpart for every public name of the JAX package.

    python3 tests/test_torch_completeness.py   # lists the names left over

Walks the top level of every module of `desed_task_tpu/` (classes and
functions whose names do not start with "_") and looks each name up in the
port's module of the same path (`MODULES` where the port renamed the
module): among its top-level classes, functions, assignments and the names
it imports. A JAX idiom whose work the port does elsewhere is listed in
COUNTERPARTS by (JAX module, name), with where that work is. Each listed
idiom must still exist in its JAX module and be absent from the port's, so
the list holds no stale entry.
"""

from __future__ import annotations

import ast
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
JAX, PORT = ROOT / "desed_task_tpu", ROOT / "desed_task_tpu_torch"
MODULES = {  # JAX module -> the port's module of the same work
    "models/torch_convert.py": "models/convert.py",
    "ops/pallas_cnn.py": "ops/fused_cnn.py",
    "ops/pallas_gru.py": "ops/gru.py",
    "ops/pallas_mel.py": "ops/fused_mel.py",
}
COUNTERPARTS = {
    ("data/device_cache.py", "upload_chunked"): "DeviceResidentData.upload",
    ("metrics/segments.py", "scores_to_dataframe"): "scores_to_table (a column table)",
    ("models/cnn.py", "fast_conv3x3"): "a TPU tiling of the same conv (a layout workaround)",
    ("obs/macs.py", "compiled_flops"): "forward_macs (analytic)",
    ("obs/profiling.py", "StepTimer"): "the desed.step spans under obs/profiling.trace",
    ("ops/dropout.py", "PackedDropout"): "packed_keep_mask",
    ("ops/pallas_cnn.py", "BlockDims"): "the kernels' plans in ops/fused_cnn.py",
    ("ops/pallas_gru.py", "bigru_pallas"): "ops/gru.bigru",
    ("ops/pallas_mel.py", "pallas_log_mel"): "ops/fused_mel.fused_log_mel",
    ("parallel/mesh.py", "batch_sharding"): "shard_batch",
    ("parallel/tp.py", "beats_param_spec"): "shard_beats",
    ("parallel/tp.py", "shard_params"): "shard_beats",
    ("tools/separation.py", "JaxSeparationModel"): "TorchSeparationModel",
    ("training/separation_pretrain.py", "make_eval_step"): "eval_step",
    ("training/sepsed.py", "create_sepsed_state"):
        "training.create_state on models/ensemble.EnsembleModel",
}


def public_names(path: Path, port: bool) -> set[str]:
    """Top-level public classes and functions of a module; of a port module
    also its assignments and the names it imports."""
    if not path.is_file():
        return set()
    out = set()
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            out.add(node.name)
        elif port and isinstance(node, ast.Assign):
            out |= {t.id for t in node.targets if isinstance(t, ast.Name)}
        elif port and isinstance(node, ast.ImportFrom):
            out |= {a.asname or a.name for a in node.names}
    return {n for n in out if not n.startswith("_")}


def port_module(module: str) -> Path:
    return PORT / MODULES.get(module, module)


def unported() -> dict[tuple[str, str], str]:
    """(JAX module, name) -> the port module it was looked up in, for every
    JAX name without a counterpart."""
    left = {}
    for path in sorted(JAX.rglob("*.py")):
        module = str(path.relative_to(JAX))
        twin = port_module(module)
        have = public_names(twin, port=True)
        for name in sorted(public_names(path, port=False)):
            if name not in have and (module, name) not in COUNTERPARTS:
                left[(module, name)] = str(twin.relative_to(ROOT))
    return left


def test_every_jax_name_has_a_counterpart():
    assert unported() == {}


def test_the_idiom_list_names_jax_names_only():
    for module, name in COUNTERPARTS:
        assert name in public_names(JAX / module, port=False), (module, name)
        assert name not in public_names(port_module(module), port=True), (module, name)
    for module, twin in MODULES.items():
        assert (JAX / module).is_file() and (PORT / twin).is_file(), module


if __name__ == "__main__":
    rest = unported()
    for (module, name), twin in rest.items():
        print(f"desed_task_tpu/{module}: {name} (not in {twin})")
    print(f"{len(rest)} public names without a counterpart in desed_task_tpu_torch/")
    sys.exit(1 if rest else 0)
