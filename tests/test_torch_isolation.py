"""The port stands alone: it imports neither jax nor the JAX package, needs
no pandas on the serving path, and its entry points refuse to fall back to
the CPU silently."""

import ast
import subprocess
import sys
from pathlib import Path

import pytest
import torch

PKG = Path(__file__).resolve().parents[1] / "desed_task_tpu_torch"
MODULES = sorted(
    "desed_task_tpu_torch." + ".".join(p.relative_to(PKG).with_suffix("").parts)
    for p in PKG.rglob("*.py") if p.name != "__init__.py"
)


def _forbidden(name: str) -> bool:
    return (name in ("jax", "flax", "desed_task_tpu")
            or name.startswith(("jax.", "flax.", "desed_task_tpu.")))


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import importlib, sys\n"
        f"for m in {MODULES!r}: importlib.import_module(m)\n"
        "bad = [m for m in sys.modules if m in ('jax', 'flax', 'desed_task_tpu', 'pandas')"
        " or m.startswith(('jax.', 'flax.', 'desed_task_tpu.'))]\n"
        "print(len(sys.modules)); assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=PKG.parent,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr[-2000:]


def test_source_scan_finds_no_jax_import():
    for path in [*PKG.rglob("*.py"), PKG.parent / "chip_smoke.py"]:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            assert not any(_forbidden(n) for n in names), f"{path}: imports {names}"


def test_entry_point_without_cpu_raises_when_no_cuda(monkeypatch):
    from desed_task_tpu_torch.inference.pipeline import InferencePipeline
    from desed_task_tpu_torch.labels import ManyHotEncoder
    from desed_task_tpu_torch.recipes_config import crnn_2024

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    enc = ManyHotEncoder(["A"] * 27, 10, 2048, 256, 4, 16000)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferencePipeline(crnn_2024(), None, enc)
    pipe = InferencePipeline(crnn_2024(), None, enc, device="cpu")
    assert pipe.device.type == "cpu"


def test_train_entry_point_without_cpu_raises_when_no_cuda(monkeypatch):
    from desed_task_tpu_torch.models.crnn import CRNN
    from desed_task_tpu_torch.recipes_config import mean_teacher_2024
    from desed_task_tpu_torch.training import create_state, make_optimizer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    net = dict(nclass=3, n_RNN_cell=4, n_layers_RNN=1, kernel_size=[3], padding=[1],
               stride=[1], nb_filters=[4], pooling=[[1, 4]], n_mels=8)
    cfg = mean_teacher_2024()
    tx, _ = make_optimizer(1e-3, 10)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        create_state(CRNN(**net), cfg, tx)
    state = create_state(CRNN(**net), cfg, tx, device="cpu")
    assert next(state.student.parameters()).device.type == "cpu"


def test_train_step_refuses_unported_options():
    from desed_task_tpu_torch.recipes_config import mean_teacher_2021
    from desed_task_tpu_torch.training import make_optimizer, make_train_step

    cfg = mean_teacher_2021()
    tx, sched = make_optimizer(1e-3, 10)
    for kw in (dict(accumulate=2), dict(axis_name="data"), dict(embedder=object())):
        with pytest.raises(NotImplementedError):
            make_train_step(cfg, tx, sched, **kw)


def test_kernel_build_keys_on_source_hash(tmp_path, monkeypatch):
    """A changed source gets a new library name (so it is rebuilt), and a
    missing nvcc is an error, not a fallback."""
    from desed_task_tpu_torch.ops import _build

    src = tmp_path / "gru.cu"
    src.write_text((PKG / "csrc" / "gru.cu").read_text())
    before = _build.library_path(src)
    src.write_text(src.read_text() + "\n// edited\n")
    assert _build.library_path(src) != before
    assert before.name.startswith("gru-") and before.parent == _build.BUILD_DIR
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc_path()
    with pytest.raises(ValueError, match="CUDA"):
        _build.require_cuda_f32("k", torch.zeros(2))
