"""Model complexity: multiply-accumulates of the CRNN, counted from its layer
shapes (counterpart of desed_task_tpu/obs/macs.py).

The JAX package reads XLA's cost analysis of the compiled forward. PyTorch
has none, and torch.utils.flop_counter does not see the hand-written
kernels, so the port counts analytically: the 3x3 convolutions, the GLU
and context-gating linears (relu and leakyrelu have none), the embedding
aggregation and projection, the BiGRU(s) and the heads, at the shapes the
forward takes. Under `cnn_integration` the CNN runs once for each of the
n_in_channel input maps, and the layers after it are that much wider. The count is the same whichever
path (kernels or plain versions, fp32 or bf16) runs the model. Elementwise
work (BatchNorm, gates, pooling, activations) is not counted; the
reference's THOP count (local/utils.py:226-256; 930.902 MMACs for the
2023 CRNN on 10 s) counts some of it.
"""

from __future__ import annotations


def _gru_macs(gru, in_dim: int, steps: int) -> int:
    """Both directions of every layer: input and recurrent products."""
    h, macs = gru.hidden, 0
    for layer in range(gru.num_layers):
        d = in_dim if layer == 0 else 2 * h
        macs += 2 * steps * 3 * h * (d + h)
    return macs


def forward_macs(model, n_frames: int, n_mels: int, emb_frames: int | None = None) -> dict:
    """MACs of one clip's forward through `model` (models.crnn.CRNN) from
    log-mel features [n_mels, n_frames]; emb_frames: the frame embeddings'
    length (frame-level embeddings only). Returns {"macs", "flops",
    "by_layer": {name: macs}}."""
    cnn = model.cnn
    maps = model.n_in_channel if model.cnn_integration else 1  # CNN passes a clip
    by = {}
    t, f = n_frames, n_mels
    for i in range(cnn.n_blocks):
        conv = getattr(cnn, f"conv{i}")
        co, ci, kh, kw = conv.weight.shape
        by[f"conv{i}"] = maps * t * f * co * ci * kh * kw
        if cnn.activation in ("glu", "cg"):
            by[f"{cnn.activation}{i}"] = maps * t * f * co * co
        pt, pf = cnn.pooling[i]
        t, f = t // pt, f // pf
    nb = co * maps
    cnn_out = f * nb
    rnn_in = cnn_out
    if model.use_embeddings:
        agg = model.aggregation_type
        if agg in ("global", "frame"):
            if agg == "frame":  # a BiGRU over the embedding frames
                enc = model.frame_embs_encoder
                by["frame_embs_encoder"] = _gru_macs(enc, enc.weight_ih_l0.shape[1], emb_frames)
            by["shrink_emb"] = model.shrink_emb_dense.in_features * nb  # once a clip
        elif agg == "pool1d":  # [E, emb_frames] @ [emb_frames, t]
            by["pool1d"] = (model.cat_tf.in_features - cnn_out) * emb_frames * t
        by["cat_tf"] = t * model.cat_tf.in_features * nb
        rnn_in = nb
    by["rnn"] = _gru_macs(model.rnn, rnn_in, t)
    for name, mod in model.named_children():
        if name.startswith("dense"):
            by[name] = t * mod.in_features * mod.out_features
    macs = sum(by.values())
    return {"macs": macs, "flops": 2 * macs, "by_layer": by}


def macs_report(model, n_frames: int, n_mels: int, emb_frames: int | None = None) -> str:
    c = forward_macs(model, n_frames, n_mels, emb_frames)
    return (f"forward pass: {c['macs'] / 1e6:.3f} MMACs ({c['flops'] / 1e9:.3f} GFLOPs), "
            f"counted from the layer shapes")
