"""BEATs pretraining on the card: masked-patch SSL, then a weak-label
fine-tune (counterpart of desed_task_tpu/training/beats_pretrain.py).

1. `pretrain_beats`: BERT/MAE-style masked-patch prediction. The fbank is
   cut into the encoder's own 16x16 patch grid (time-major, then
   frequency); round(mask_ratio * n_tokens) tokens a clip, exactly, are
   replaced by the learned mask token (models/beats.BEATsEncoder's
   `mask_indices` seam); a linear head regresses the per-patch-normalised
   fbank pixels of the masked tokens; the loss is their MSE.
2. `finetune_beats_weak`: clip-level multi-label BCE of a mean-pooled
   linear head on weak labels.

Both write the encoder as a torch file in the released BEATs layout with
its BEATsConfig ({"cfg", "model"}; the pretraining-only mask token
stripped), which tools/embeddings.build_embedder and
`finetune_beats_weak(init_params_path=...)` load.

As in JAX: AdamW (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay on
every parameter) with optax's warmup_cosine_decay_schedule(0, lr, warmup,
max(steps, warmup + 1)) read at the count before the increment, so the
first step has lr 0 and changes nothing; the clips live on the card as an
int16 store (data/device_cache.AUDIO_SCALE) and a step gathers its batch
by index; the batch indices come from numpy's default_rng(seed), the mask
scores from the step's torch.Generator. `compute_dtype="bfloat16"` casts
the fp32 master weights to bf16 inside the loss (gradients reach the
masters through the cast); the fbank input is cast too, targets and loss
stay fp32. fp32 steps pin fp32 (`device.fp32_math`) around the forward and
the backward.
"""

from __future__ import annotations

import dataclasses
import math
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..data.device_cache import AUDIO_SCALE, _to_device, _to_int16
from ..device import fp32_math, resolve_device
from ..models.beats import BEATsConfig, BEATsEncoder, init_beats
from ..ops.kaldi import beats_preprocess


@dataclasses.dataclass(frozen=True)
class BEATsPretrainConfig:
    beats: BEATsConfig = BEATsConfig()
    mask_ratio: float = 0.6
    lr: float = 5e-4
    weight_decay: float = 0.01
    warmup_steps: int = 250
    batch_size: int = 32
    steps: int = 3000
    seed: int = 0
    compute_dtype: str = "float32"  # "bfloat16": bf16 weights and fbank in the encoder


def patch_targets(fbank: torch.Tensor, patch: int) -> torch.Tensor:
    """fbank [B, T, F] -> per-token patch pixels [B, tt * ff, patch * patch],
    tokens in the patch conv's order (time-major, then frequency)."""
    B, T, Fq = fbank.shape
    tt, ff = T // patch, Fq // patch
    x = fbank[:, : tt * patch, : ff * patch].reshape(B, tt, patch, ff, patch)
    return x.permute(0, 1, 3, 2, 4).reshape(B, tt * ff, patch * patch)


def n_tokens_for(cfg: BEATsConfig, n_samples: int) -> int:
    """The encoder's token count for a clip length (Kaldi 25 / 10 ms framing,
    then the patch on both axes)."""
    n_frames = 1 + (n_samples - 400) // 160
    return (n_frames // cfg.input_patch_size) * (128 // cfg.input_patch_size)


def _compute_dtype(name: str) -> torch.dtype:
    return torch.bfloat16 if name == "bfloat16" else torch.float32


def _encode(model: BEATsEncoder, fbank: torch.Tensor, cdt: torch.dtype, **kw) -> torch.Tensor:
    """The encoder's features in fp32; in bf16 through its weights cast to
    bf16 (torch.func.functional_call: the casts are differentiable)."""
    if cdt == torch.float32:
        return model(fbank, **kw)
    params = {n: p.to(cdt) if p.dtype == torch.float32 else p
              for n, p in model.named_parameters()}
    return torch.func.functional_call(model, params, (fbank.to(cdt),), kw).float()


def masked_patch_loss(model: BEATsEncoder, audio: torch.Tensor, mask: torch.Tensor,
                      head: nn.Linear, compute_dtype: torch.dtype = torch.float32
                      ) -> torch.Tensor:
    """MSE between the head's prediction and the per-patch-normalised pixels
    of the masked tokens; mask [B, n_tokens] bool. Targets and loss fp32."""
    fbank = beats_preprocess(audio)
    tgt = patch_targets(fbank, model.cfg.input_patch_size)
    tgt = (tgt - tgt.mean(-1, keepdim=True)) / (tgt.std(-1, keepdim=True, correction=0) + 1e-6)
    feats = _encode(model, fbank, compute_dtype, mask_indices=mask)
    pred = feats @ head.weight.T + head.bias
    err = ((pred - tgt) ** 2).mean(-1)  # [B, n_tokens]
    return (err * mask).sum() / torch.clamp(mask.sum(), min=1)


def warmup_cosine(cfg: BEATsPretrainConfig):
    """optax.warmup_cosine_decay_schedule(0, lr, warmup, max(steps, warmup
    + 1)), end value 0: count -> learning rate."""
    decay = max(cfg.steps, cfg.warmup_steps + 1) - cfg.warmup_steps

    def schedule(count: int) -> float:
        if count < cfg.warmup_steps:
            return cfg.lr * count / cfg.warmup_steps
        t = min(count - cfg.warmup_steps, decay)
        return cfg.lr * 0.5 * (1.0 + math.cos(math.pi * t / decay))

    return schedule


def make_optimizer(params, cfg: BEATsPretrainConfig) -> torch.optim.AdamW:
    """optax.adamw's defaults, weight decay on every parameter."""
    return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=cfg.weight_decay)


def _scheduled_step(optimizer: torch.optim.Optimizer, schedule, count: int) -> None:
    """One optimizer step at the schedule's rate for the count before it."""
    for group in optimizer.param_groups:
        group["lr"] = schedule(count)
    optimizer.step()


def make_pretrain_step(model: BEATsEncoder, head: nn.Linear, cfg: BEATsPretrainConfig,
                       optimizer: torch.optim.Optimizer, n_tokens: int):
    """step(audio_store [N, n] int16, idx [B] long, generator, mask=None) ->
    loss (0-d tensor), updating `model`, `head` and `optimizer` in place.
    The mask takes round(mask_ratio * n_tokens) tokens a clip (a threshold at
    the sorted uniform scores from `generator`); a test hands its own."""
    mask_count = int(round(cfg.mask_ratio * n_tokens))
    cdt = _compute_dtype(cfg.compute_dtype)
    schedule = warmup_cosine(cfg)
    count = [0]

    def step(audio_store, idx, generator, mask=None):
        audio = audio_store[idx].float() / AUDIO_SCALE
        if mask is None:
            scores = torch.rand((audio.shape[0], n_tokens), generator=generator,
                                device=audio.device)
            thresh = torch.sort(scores, dim=-1).values[:, mask_count - 1 : mask_count]
            mask = scores <= thresh
        optimizer.zero_grad(set_to_none=True)
        with fp32_math():
            loss = masked_patch_loss(model, audio, mask, head, cdt)
            loss.backward()
        _scheduled_step(optimizer, schedule, count[0])
        count[0] += 1
        return loss.detach(), mask

    return step


def make_finetune_step(model: BEATsEncoder, head: nn.Linear, cfg: BEATsPretrainConfig,
                       optimizer: torch.optim.Optimizer):
    """step(audio_store, label_store, idx) -> loss: sigmoid BCE of the
    mean-pooled features' logits against the clips' multi-hot labels."""
    cdt = _compute_dtype(cfg.compute_dtype)
    schedule = warmup_cosine(cfg)
    count = [0]

    def step(audio_store, label_store, idx):
        audio = audio_store[idx].float() / AUDIO_SCALE
        optimizer.zero_grad(set_to_none=True)
        with fp32_math():
            feats = _encode(model, beats_preprocess(audio), cdt)
            logits = feats.mean(1) @ head.weight.T + head.bias
            loss = F.binary_cross_entropy_with_logits(logits, label_store[idx])
            loss.backward()
        _scheduled_step(optimizer, schedule, count[0])
        count[0] += 1
        return loss.detach()

    return step


def _audio_store(wav_files: list, pad_to: int, dev: torch.device) -> torch.Tensor:
    """The clips, decoded on host threads, as an int16 [N, pad_to] store on `dev`."""
    from ..data.audio_io import read_audio

    load = lambda p: _to_int16(read_audio(p, pad_to=pad_to, test=False)[0])
    with ThreadPoolExecutor(max_workers=8) as pool:
        host = np.stack(list(pool.map(load, wav_files)))
    return _to_device(host, dev, 64 << 20)


def _head(dim: int, out: int, seed: int) -> nn.Linear:
    """Linear head, weights normal(0.02) from `seed`, bias 0."""
    head = nn.Linear(dim, out)
    with torch.no_grad():
        head.weight.copy_(0.02 * torch.randn(out, dim, generator=torch.Generator().manual_seed(
            seed)))
        head.bias.zero_()
    return head


def _train(step_fn, n_clips: int, cfg: BEATsPretrainConfig, tag: str, log_every: int,
           verbose: bool, run_info: dict | None):
    """The step loop: numpy batch indices, a host sync a step (the loss,
    which feeds the watchdog and bounds run-ahead), the step times."""
    from ..obs.watchdog import StallWatchdog

    wd = StallWatchdog()
    wd.start()
    wd.arm()
    rng = np.random.default_rng(cfg.seed)
    losses, step_s = [], []
    t0 = time.monotonic()
    try:
        for i in range(cfg.steps):
            idx = torch.from_numpy(rng.integers(0, n_clips, cfg.batch_size))
            ts = time.perf_counter()
            loss = float(step_fn(idx, i))
            step_s.append(time.perf_counter() - ts)
            losses.append(loss)
            wd.beat()
            if verbose and (i % log_every == 0 or i == cfg.steps - 1):
                print(f"[{tag}] step {i}/{cfg.steps} loss {loss:.4f} "
                      f"({(time.monotonic() - t0) / (i + 1):.2f}s/step)", flush=True)
    finally:
        wd.disarm()
        wd.stop()
    if run_info is not None:
        run_info.update(losses=losses, step_s=step_s)


def _save_encoder(encoder: BEATsEncoder, out_path, verbose: bool, tag: str) -> str:
    """The encoder in the released BEATs layout with its BEATsConfig, the mask
    token stripped: {"cfg": dict, "model": state_dict}."""
    from ..models.convert import to_reference_beats

    state = {k: v.detach().float().cpu() for k, v in encoder.state_dict().items()}
    out = Path(out_path)
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"cfg": dataclasses.asdict(encoder.cfg),
                "model": to_reference_beats(state, encoder.cfg.encoder_layers)}, out)
    if verbose:
        print(f"[{tag}] saved encoder -> {out}", flush=True)
    return str(out)


def pretrain_beats(wav_files: list, out_path, cfg: BEATsPretrainConfig = BEATsPretrainConfig(),
                   pad_to: int = 160000, log_every: int = 50, verbose: bool = True,
                   device: str | torch.device | None = None, run_info: dict | None = None
                   ) -> str:
    """Masked-patch pretraining on a wav corpus on `device` (default "cuda");
    writes the encoder to `out_path`. `run_info` receives the losses, the
    step times and each step's masked-token counts per clip."""
    dev = resolve_device(device)
    wav_files = [str(f) for f in wav_files]
    if not wav_files:
        raise ValueError("no wav files")
    t0 = time.monotonic()
    store = _audio_store(wav_files, pad_to, dev)
    if verbose:
        print(f"[beats-pretrain] decoded {len(wav_files)} clips ({store.numel() * 2 / 1e6:.0f} "
              f"MB) in {time.monotonic() - t0:.0f}s", flush=True)
    model = init_beats(BEATsEncoder(cfg.beats, mask_token=True),
                       torch.Generator().manual_seed(cfg.seed)).to(dev).train()
    head = _head(cfg.beats.encoder_embed_dim, cfg.beats.input_patch_size ** 2,
                 cfg.seed + 1).to(dev)
    opt = make_optimizer([*model.parameters(), *head.parameters()], cfg)
    step = make_pretrain_step(model, head, cfg, opt, n_tokens_for(cfg.beats, pad_to))
    gen = torch.Generator(device=dev).manual_seed(cfg.seed)
    masked = []

    def step_fn(idx, i):
        loss, mask = step(store, idx.to(dev), gen)
        if run_info is not None:
            masked.append(mask.sum(-1).tolist())
        return loss

    _train(step_fn, len(wav_files), cfg, "beats-pretrain", log_every, verbose, run_info)
    if run_info is not None:
        run_info["masked"] = masked
    model.mask_token = None  # pretraining only: extraction builds the encoder without it
    return _save_encoder(model, out_path, verbose, "beats-pretrain")


def finetune_beats_weak(wav_files: list, labels: np.ndarray, out_path,
                        init_params_path=None, cfg: BEATsPretrainConfig = BEATsPretrainConfig(),
                        pad_to: int = 160000, log_every: int = 50, verbose: bool = True,
                        device: str | torch.device | None = None,
                        run_info: dict | None = None) -> str:
    """Clip-level multi-label BCE fine-tune of the encoder (mean-pooled
    linear head) on `device` (default "cuda"), from `init_params_path` (a
    file `pretrain_beats` wrote) or seeded weights; writes the encoder (the
    head discarded) to `out_path`."""
    dev = resolve_device(device)
    wav_files = [str(f) for f in wav_files]
    labels = np.asarray(labels, np.float32)
    if len(wav_files) != len(labels):
        raise ValueError(f"{len(wav_files)} wavs, {len(labels)} label rows")
    store = _audio_store(wav_files, pad_to, dev)
    label_store = torch.as_tensor(labels, device=dev)
    model = init_beats(BEATsEncoder(cfg.beats), torch.Generator().manual_seed(cfg.seed))
    if init_params_path is not None:
        from ..models.convert import from_jax_embedder_params, load_beats_checkpoint

        _, tree = load_beats_checkpoint(init_params_path)
        model.load_state_dict(from_jax_embedder_params(tree), strict=True)
        if verbose:
            print(f"[beats-finetune] init from {init_params_path}", flush=True)
    model = model.to(dev).train()
    head = _head(cfg.beats.encoder_embed_dim, labels.shape[1], cfg.seed + 2).to(dev)
    opt = make_optimizer([*model.parameters(), *head.parameters()], cfg)
    step = make_finetune_step(model, head, cfg, opt)
    _train(lambda idx, i: step(store, label_store, idx.to(dev)), len(wav_files), cfg,
           "beats-finetune", log_every, verbose, run_info)
    return _save_encoder(model, out_path, verbose, "beats-finetune")
