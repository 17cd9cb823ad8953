"""Analytic work of the CRNN and its front end, frozen with the benchmark.

`crnn_macs` is the program's `obs/macs.forward_macs` as it stood when the
benchmark was defined, rewritten on the configuration dict instead of the
module: the 3x3 convolutions, the GLU linears, the pool1d aggregation and
`cat_tf`, the BiGRU's input and recurrent products and the heads, per clip
from log-mel features [n_mels, n_frames]. Elementwise work (BatchNorm,
gates, pooling) is not counted. A test holds it equal to the program's
counter, so a later change of the counter shows there and not here.

`log_mel_flops` counts the front end as an rFFT (2.5 n log2 n operations a
frame of n samples) plus the magnitude and the mel projection, never as
the DFT-as-GEMM that the program computes: a change of how the DFT is
computed is judged on the same work.
"""

from __future__ import annotations

import math


def _gru_macs(hidden: int, layers: int, in_dim: int, steps: int) -> int:
    macs = 0
    for layer in range(layers):
        d = in_dim if layer == 0 else 2 * hidden
        macs += 2 * steps * 3 * hidden * (d + hidden)
    return macs


def crnn_macs(config: dict) -> dict:
    """{"macs", "by_layer"} of one clip's CRNN forward."""
    net, feats = config["net"], config["feats"]
    d = config["data"]
    t = int(d["audio_max_len"] * d["fs"]) // feats["hop_length"] + 1
    f = feats["n_mels"]
    ci = net.get("n_in_channel", 1)
    by = {}
    for i, co in enumerate(net["nb_filters"]):
        k = net["kernel_size"][i]
        by[f"conv{i}"] = t * f * co * ci * k * k
        by[f"glu{i}"] = t * f * co * co
        pt, pf = net["pooling"][i]
        t, f = t // pt, f // pf
        ci = co
    cnn_out = f * ci
    rnn_in = cnn_out
    if net.get("use_embeddings"):
        emb = net["embedding_size"]
        by["pool1d"] = emb * config["embedding_frames"] * t
        by["cat_tf"] = t * (cnn_out + emb) * ci
        rnn_in = ci
    h = net["n_RNN_cell"]
    by["rnn"] = _gru_macs(h, net.get("rnn_layers") or net.get("n_layers_RNN", 1), rnn_in, t)
    by["dense"] = t * 2 * h * net["nclass"]
    by["dense_softmax"] = t * 2 * h * net["nclass"]
    return {"macs": sum(by.values()), "by_layer": by}


def log_mel_flops(config: dict) -> int:
    """One clip's front end: an rFFT a frame, |X|, the mel projection, dB."""
    feats, d = config["feats"], config["data"]
    n = feats["n_window"]
    frames = int(d["audio_max_len"] * d["fs"]) // feats["hop_length"] + 1
    bins = n // 2 + 1
    per_frame = 2.5 * n * math.log2(n) + 3 * bins + 2 * bins * feats["n_mels"]
    return int(frames * (per_frame + feats["n_mels"]))


def train_step_flops(config: dict) -> int:
    """One mean-teacher step: the student's forward and backward (3x a
    forward) and the teacher's forward, plus one front end, a clip."""
    clips = sum(s["size"] for s in config["slots"])
    return clips * (4 * 2 * crnn_macs(config)["macs"] + log_mel_flops(config))


def eval_clip_flops(config: dict) -> int:
    """One clip's eval forward and front end."""
    return 2 * crnn_macs(config)["macs"] + log_mel_flops(config)
