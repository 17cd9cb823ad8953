"""The port stands alone: it imports neither jax nor the JAX package, loads
none of pandas, yaml, h5py, matplotlib and tensorboardX when its modules
are imported (the card's machine lacks some of them; the functions that
need one import it themselves), and its entry points refuse to fall back
to the CPU silently."""

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
        "bad = [m for m in sys.modules if m in ('jax', 'flax', 'desed_task_tpu', 'pandas',"
        " 'yaml', 'h5py', 'matplotlib', 'tensorboardX')"
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


def test_train_step_refuses_unported_options(tmp_path):
    """Every option of the step is ported: the data axis's group builds (an
    axis name where the group belongs is refused)."""
    import torch.distributed as dist

    from desed_task_tpu_torch.recipes_config import mean_teacher_2021
    from desed_task_tpu_torch.training import make_optimizer, make_train_step

    cfg = mean_teacher_2021()
    tx, sched = make_optimizer(1e-3, 10)
    with pytest.raises(TypeError, match="process group"):
        make_train_step(cfg, tx, sched, axis_name="data")
    dist.init_process_group("gloo", init_method=(tmp_path / "rendezvous").as_uri(), rank=0,
                            world_size=1)
    try:
        make_train_step(cfg, tx, sched, axis_name=dist.group.WORLD)  # ported: builds
    finally:
        dist.destroy_process_group()
    make_train_step(cfg, tx, sched, accumulate=2)  # ported: builds
    make_train_step(cfg, tx, sched, embedder=lambda audio: audio)  # ported: builds


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


def test_the_2021_2023_modules_are_scanned():
    for name in ("models.tdcn", "models.ensemble", "training.mixit", "training.sepsed",
                 "training.sepsed_run", "training.separation_pretrain", "tools.separation",
                 "metrics.separation", "recipes.dcase2021_train_sed",
                 "recipes.dcase2022_train_sed", "recipes.dcase2022_train_pretrained",
                 "recipes.dcase2023_train_sed", "recipes.dcase2023_train_pretrained",
                 "recipes.dcase2021_pretrain_separation", "recipes.dcase2021_run_separation",
                 "recipes.dcase2021_finetune_on_separated"):
        assert f"desed_task_tpu_torch.{name}" in MODULES, name


def test_separation_entry_points_without_cpu_raise_when_no_cuda(monkeypatch, tmp_path):
    from desed_task_tpu_torch.tools.separation import TorchSeparationModel
    from desed_task_tpu_torch.training.separation_pretrain import pretrain_separator
    from desed_task_tpu_torch.training.sepsed_run import sepsed_single_run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TorchSeparationModel(None, n_src=2, enc_dim=8, win=16, bn_dim=8, h_dim=8, n_blocks=1,
                             n_repeats=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        pretrain_separator([tmp_path], [tmp_path], tmp_path / "log")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sepsed_single_run({"training": {}, "data": {}}, str(tmp_path / "run"), str(tmp_path))
    sep = TorchSeparationModel(None, n_src=2, device="cpu", enc_dim=8, win=16, bn_dim=8,
                               h_dim=8, n_blocks=1, n_repeats=1)
    assert next(sep.model.parameters()).device.type == "cpu"


def test_the_embedder_modules_are_scanned():
    for name in ("ops.kaldi", "models.beats", "models.panns", "models.ast", "models.convert",
                 "tools.embeddings", "training.beats_pretrain",
                 "recipes.dcase2022_extract_embeddings", "recipes.dcase2023_extract_embeddings",
                 "recipes.dcase2024_extract_embeddings"):
        assert f"desed_task_tpu_torch.{name}" in MODULES, name
    for name in ("parallel.mesh", "parallel.launch", "parallel.tp", "parallel.dryrun"):
        assert f"desed_task_tpu_torch.{name}" in MODULES, name


def test_embedder_entry_points_without_cpu_raise_when_no_cuda(monkeypatch, tmp_path):
    from desed_task_tpu_torch.models.beats import BEATsConfig, BEATsModel
    from desed_task_tpu_torch.recipes import dcase2024_extract_embeddings
    from desed_task_tpu_torch.tools.embeddings import (build_embedder, extract_folder,
                                                       extract_splits)
    from desed_task_tpu_torch.training.beats_pretrain import (finetune_beats_weak,
                                                              pretrain_beats)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tiny = BEATsModel(BEATsConfig(encoder_layers=1, encoder_embed_dim=16, embed_dim=16,
                                  encoder_ffn_embed_dim=16, encoder_attention_heads=2,
                                  conv_pos=4, conv_pos_groups=2, num_buckets=8, max_distance=16))
    wav = tmp_path / "a.wav"
    conf = tmp_path / "conf.yaml"
    conf.write_text("data: {fs: 16000, audio_max_len: 1}\n")
    calls = [lambda: build_embedder("beats"),
             lambda: extract_folder(tiny, [wav], str(tmp_path / "x.hdf5"), h5py=object()),
             lambda: extract_splits("beats", None, {}, str(tmp_path)),
             lambda: pretrain_beats([wav], tmp_path / "p.pt"),
             lambda: finetune_beats_weak([wav], [[1.0]], tmp_path / "f.pt"),
             lambda: dcase2024_extract_embeddings.main(["--conf_file", str(conf)])]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
    assert next(build_embedder("panns", device="cpu").parameters()).device.type == "cpu"


def test_parallel_entry_points_without_cpu_raise_when_no_cuda(monkeypatch, tmp_path):
    from desed_task_tpu_torch.parallel.dryrun import dryrun_multichip
    from desed_task_tpu_torch.training.single_run import single_run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        dryrun_multichip(2, device="cuda")
    # under torchrun, without a card: no group is joined and nothing runs on the CPU
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        single_run({"training": {}, "data": {}}, str(tmp_path / "run"))
