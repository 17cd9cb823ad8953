"""Ahead-of-time export of the serving pipeline: a torch.export program with
the hand-written kernels inside, and its metadata (counterpart of
desed_task_tpu/tools/export.py, which writes a StableHLO artifact).

The fused inference forward of `inference.pipeline.InferencePipeline` (mel
front-end, scaler, CRNN with its embeddings input, per-class median filter,
the full threshold sweep) is exported once with `torch.export` at a static
batch, the weights baked into the program, and saved as `forward.pt2`
beside `meta.json`. The CRNN's kernels are the torch.library custom ops
desed_torch::conv_bn_stats, desed_torch::glu_drop_pool and
desed_torch::bigru (ops/fused_cnn.py, ops/gru.py): torch.export keeps each
as one node of the graph, so the loaded program launches the same CUDA
kernels in the same order as the eager pipeline on the card, and their
plain versions on the CPU. It never swaps a kernel for a plain version.

    pipe = InferencePipeline(model, state, encoder, ...)
    export_pipeline(pipe, "serve/sed_v1", embeddings_shape=(768, 496))
    fwd, meta = load_pipeline("serve/sed_v1")
    strong, weak, activity = fwd(audio_batch, embeddings)  # static [B, N] float32

The program runs on the device it was exported on (meta["device"]).
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Optional, Sequence

import torch

ARTIFACT = "forward.pt2"
META = "meta.json"
OPS = ("desed_torch::conv_bn_stats", "desed_torch::glu_drop_pool", "desed_torch::bigru")


class _Forward(torch.nn.Module):
    """The pipeline's forward as a module: the CRNN is a submodule, so its
    parameters and buffers become the program's weights."""

    def __init__(self, pipeline):
        super().__init__()
        self.model = pipeline.model
        self._pipeline = pipeline

    def forward(self, audio, embeddings=None):
        return self._pipeline._forward_impl(audio, embeddings)


def _register_ops() -> None:
    """Importing the kernels' modules registers their custom ops."""
    from ..ops import fused_cnn, gru  # noqa: F401


def graph_ops(program) -> list[str]:
    """The desed_torch custom ops the program's graph calls, in call order
    (one entry a call)."""
    out = []
    for node in program.graph.nodes:
        if node.op == "call_function" and hasattr(node.target, "name"):
            name = node.target.name()
            if name.startswith("desed_torch::"):
                out.append(name)
    return out


def export_pipeline(
    pipeline,
    out_dir,
    batch_size: Optional[int] = None,
    embeddings_shape: Optional[Sequence[int]] = None,
):
    """Export the pipeline's forward for ahead-of-time serving.

    `embeddings_shape`: per-clip shape (e.g. (768, 496)) for models fed
    precomputed embeddings; the program then takes (audio, embeddings).
    Returns the artifact directory as a Path.
    """
    _register_ops()
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    bs = int(batch_size or pipeline.batch_size)
    dev = pipeline.device
    args = [torch.zeros((bs, pipeline.pad_to), dtype=torch.float32, device=dev)]
    if embeddings_shape is not None:
        args.append(torch.zeros((bs, *embeddings_shape), dtype=torch.float32, device=dev))
    # one eager call first: the front-end's, the median filter's and the
    # GRU's per-device constant caches then hold real tensors, which the
    # trace takes as the program's constants (a cache first filled inside
    # the trace would keep its fake tensors)
    pipeline.forward(*args)
    with torch.no_grad():
        program = torch.export.export(_Forward(pipeline).eval(), tuple(args), strict=False)
    # the example batch would be saved with the program: at batch 64 with
    # 768x496 embeddings its zeros are 138 MB of a 160 MB file
    program.example_inputs = None
    torch.export.save(program, str(out / ARTIFACT))

    enc = pipeline.encoder
    meta = {
        "labels": list(enc.labels),
        "fs": int(enc.fs),
        "audio_len": float(enc.audio_len),
        "frame_hop": int(enc.frame_hop),
        "net_pooling": int(enc.net_pooling),
        "batch_size": bs,
        "pad_to": int(pipeline.pad_to),
        "thresholds": list(pipeline.thresholds),
        "median_filter": list(pipeline.median) if pipeline.median else None,
        "embeddings_shape": (
            list(embeddings_shape) if embeddings_shape is not None else None
        ),
        "device": str(dev),
        "device_name": (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"),
        "torch_version": torch.__version__,
        "ops": graph_ops(program),
        "outputs": ["strong [B,C,T]", "weak [B,C]",
                    "activity [n_th,B,C,T] bool"],
    }
    (out / META).write_text(json.dumps(meta, indent=2))
    return out


def load_pipeline(artifact_dir):
    """Load an exported forward. Returns (callable, metadata dict).

    The callable takes the static-shape float32 tensors recorded in the
    metadata, on the device the program was exported on, and returns
    (strong, weak, activity). On the card it runs the front-end's and the
    heads' products in fp32, as InferencePipeline does (TF32 off)."""
    _register_ops()
    d = Path(artifact_dir)
    program = torch.export.load(str(d / ARTIFACT))
    meta = json.loads((d / META).read_text())
    module = program.module()
    if meta["device"].startswith("cuda"):
        torch.backends.cuda.matmul.allow_tf32 = False

    def forward(*args):
        with torch.no_grad():
            return module(*args)

    return forward, meta
