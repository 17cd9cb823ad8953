"""Everything a run feeds the program, made from --seed: weights, the train
store, the eval set, each step's rows, the step generator's seed.

Each kind of input has a seed of its own (numpy SeedSequence children of
--seed), so any one of them can be made again alone, the same: the
reference regenerates the rows it checks instead of reading what the
program held. Bulk data is made on the device, a few calls a field.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .reference.model import crnn_forward, fp32_math, mel_magnitude, minmax_scale, \
    param_spec, to_db

EVENT_SHARE = 0.15  # share of (clip, class) pairs that hold an event
TONES = 3  # tonal events a clip, over its noise floor
CHUNK = 256  # clips a generator call


def seeds(seed: int) -> dict:
    """The input seeds of a run, each < 2**63."""
    kids = np.random.SeedSequence(int(seed)).spawn(4)
    names = ("weights", "data", "rows", "step")
    return {n: int(k.generate_state(2, np.uint32).astype(np.uint64) @ [1 << 31, 1])
            for n, k in zip(names, kids)}


def device_generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def make_weights(config: dict, seed: int, device) -> dict:
    """{name: fp32 tensor} of the CRNN in the checkpoint names: conv and
    dense kernels normal with std 1 / sqrt(fan_in), GRU tensors uniform in
    +-1 / sqrt(H), biases 0, norm scales 1, BatchNorm statistics near 0
    and 1 (what a trained model's look like, so that eval sees spread).
    One normal and one uniform call for all of them."""
    spec = param_spec(config["net"], config["feats"]["n_mels"])
    g = device_generator(device, seed)
    n_normal = sum(math.prod(s) for _, s, kind, _ in spec if kind in ("normal", "stat_mean"))
    n_unif = sum(math.prod(s) for _, s, kind, _ in spec if kind in ("uniform", "stat_var"))
    normal = torch.randn(n_normal, generator=g, device=device)
    unif = torch.rand(n_unif, generator=g, device=device)
    out, i, j = {}, 0, 0
    for name, shape, kind, fan in spec:
        n = math.prod(shape)
        if kind in ("normal", "stat_mean"):
            v = normal[i:i + n].view(shape)
            i += n
            out[name] = v * (1.0 / math.sqrt(fan)) if kind == "normal" else v * 0.1
        elif kind in ("uniform", "stat_var"):
            v = unif[j:j + n].view(shape)
            j += n
            out[name] = (v * 2.0 - 1.0) / math.sqrt(fan) if kind == "uniform" else 0.5 + v
        elif kind == "zeros":
            out[name] = torch.zeros(shape, device=device)
        else:
            out[name] = torch.ones(shape, device=device)
    return {k: v.contiguous() for k, v in out.items()}


def with_data_statistics(weights: dict, config: dict, audio: torch.Tensor,
                         embeddings: torch.Tensor | None) -> dict:
    """A copy of `weights` whose BatchNorm running statistics are those of
    the clips `audio` (int16 [B, N]) and `embeddings`: one train-mode
    forward of the fp32 reference with no dropout, SpecAugment or
    dropstep, which leaves 0.01 of the old statistics and 0.99 of the
    batch's. A trained model's statistics follow its data; without them
    the seeded CRNN scores every clip nearly alike in eval mode."""
    net = dict(config["net"], dropout=0.0, dropout_recurrent=0.0, dropstep_recurrent=0.0,
               specaugm_t_p=0.0, specaugm_f_p=0.0)
    p = {k: v.clone() for k, v in weights.items()}
    cmask = torch.ones((audio.shape[0], net["nclass"]), dtype=torch.bool, device=audio.device)
    with fp32_math(), torch.no_grad():
        x = minmax_scale(to_db(mel_magnitude(audio.float() / 32768.0, config["feats"])))
        emb = None if embeddings is None else embeddings.float()
        crnn_forward(p, net, x, emb, cmask, True, None)
    return p


def clip_shapes(config: dict) -> dict:
    """Per-clip shapes: audio samples, labels [C, T'], embeddings [E, Te] or None."""
    d, f, net = config["data"], config["feats"], config["net"]
    n = int(d["audio_max_len"] * d["fs"])
    frames = n // f["hop_length"] + 1
    emb = (net["embedding_size"], config["embedding_frames"]) if net.get("use_embeddings") \
        else None
    return {"audio": n, "labels": (net["nclass"], frames // d["net_subsample"]),
            "embeddings": emb}


def clip_bytes(config: dict) -> int:
    """Bytes of one stored clip: int16 audio, fp32 labels and embeddings."""
    s = clip_shapes(config)
    b = 2 * s["audio"] + 4 * math.prod(s["labels"])
    return b + (4 * math.prod(s["embeddings"]) if s["embeddings"] else 0)


def store_rows(config: dict, budget_bytes: int) -> dict:
    """Clips a slot in the train store: the whole batches that fit the byte
    budget, the same number of batches for every slot."""
    batch = sum(s["size"] for s in config["slots"])
    n_batches = budget_bytes // (batch * clip_bytes(config))
    if n_batches < 3:
        raise ValueError(f"a store of {budget_bytes} B holds {n_batches} batches; "
                         "the checked steps need 3")
    return {s["name"]: int(n_batches * s["size"]) for s in config["slots"]}


def eval_rows(config: dict, clips: int) -> int:
    """Rows of the eval cache: clips padded to whole batches of batch_size_val."""
    bs = config["training"]["batch_size_val"]
    return -(-clips // bs) * bs


def eval_cache_bytes(config: dict, clips: int) -> int:
    """Bytes of the eval cache: int16 audio and embeddings of the padded rows."""
    s = clip_shapes(config)
    per = 2 * s["audio"] + (4 * math.prod(s["embeddings"]) if s["embeddings"] else 0)
    return eval_rows(config, clips) * per


def make_clips(config: dict, n: int, seed: int, device, fields=("audio", "labels",
                                                                "embeddings")) -> dict:
    """n seeded clips on the device: audio (`make_audio`), labels with one
    event (onset, length) on EVENT_SHARE of the (clip, class) pairs,
    embeddings standard normal. Each field from a generator of its own."""
    s = clip_shapes(config)
    base = np.random.SeedSequence(int(seed)).generate_state(3, np.uint32)
    out = {}
    if "audio" in fields:
        out["audio"] = make_audio(n, s["audio"], config["data"]["fs"], int(base[0]), device)
    if "labels" in fields:
        g = device_generator(device, int(base[1]))
        C, T = s["labels"]
        active = torch.rand((n, C), generator=g, device=device) < EVENT_SHARE
        on = torch.randint(0, T, (n, C), generator=g, device=device)
        length = torch.randint(1, T + 1, (n, C), generator=g, device=device)
        t = torch.arange(T, device=device)
        out["labels"] = ((t >= on[..., None]) & (t < (on + length)[..., None])
                         & active[..., None]).float()
    if "embeddings" in fields and s["embeddings"] is not None:
        e = torch.empty((n, *s["embeddings"]), dtype=torch.float32, device=device)
        e.normal_(generator=device_generator(device, int(base[2])))
        out["embeddings"] = e
    return out


def make_audio(n: int, samples: int, fs: int, seed: int, device) -> torch.Tensor:
    """int16 [n, samples]: each clip a white-noise floor at its own level
    (50 to 4000) and TONES tonal events (50 Hz to 7.5 kHz, amplitude up
    to 8000, each on for a random span), so that clips differ in level,
    spectrum and time course. Made CHUNK clips a call."""
    g = device_generator(device, seed)
    out = torch.empty((n, samples), dtype=torch.int16, device=device)
    idx = torch.arange(samples, device=device, dtype=torch.float32)
    for a in range(0, n, CHUNK):
        r = min(CHUNK, n - a)
        u = lambda: torch.rand((r, 1), generator=g, device=device)  # noqa: E731
        x = torch.randn((r, samples), generator=g, device=device) * (50.0 + 3950.0 * u())
        for _ in range(TONES):
            f, amp, phase, on, span = 50.0 + 7450.0 * u(), 8000.0 * u(), 6.2832 * u(), u(), u()
            gate = (idx >= on * samples) & (idx < (on + span) * samples)
            x += amp * torch.sin(6.283185307 * f / fs * idx + phase) * gate
        out[a:a + r] = x.clamp_(-32768, 32767).round_().to(torch.int16)
    return out


def slot_masks(config: dict) -> dict:
    """{slot: bool [C]}: the classes each slot's labels are valid for."""
    c = config["net"]["nclass"]
    out = {}
    for s in config["slots"]:
        m = np.zeros(c, bool)
        m[s["classes"]] = True
        out[s["name"]] = m
    return out


class RowOrder:
    """Each step's store rows, slot by slot: every slot walks a fresh
    permutation of its rows each epoch (the batcher's sampling), from the
    rows seed."""

    def __init__(self, config: dict, rows: dict, seed: int):
        self.slots = [(s["name"], s["size"]) for s in config["slots"]]
        self.rows = rows
        self.rng = np.random.default_rng(int(seed))
        self.pending = {name: np.empty(0, np.int64) for name, _ in self.slots}

    def next(self) -> dict:
        out = {}
        for name, size in self.slots:
            if len(self.pending[name]) < size:
                self.pending[name] = np.concatenate(
                    [self.pending[name], self.rng.permutation(self.rows[name])])
            out[name], self.pending[name] = self.pending[name][:size], self.pending[name][size:]
        return out
