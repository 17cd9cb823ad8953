"""The frozen work counts and byte reckonings: the CRNN count equals the
program's own counter, the store and cache fills are the figures the cells
state, and every least time is below what a kernel can reach."""

from __future__ import annotations

import pytest

from sedbench import inputs, run
from sedbench.yardstick import flops, roofline


def _config(workload: str) -> dict:
    return run.cell_files(workload, run.manifest())["config"]


@pytest.mark.parametrize("workload", ["train_2024_bf16", "train_2023_bf16"])
def test_frozen_count_equals_the_program_counter(workload):
    from desed_task_tpu_torch.obs.macs import forward_macs
    from desed_task_tpu_torch.training.single_run import build_model

    c = _config(workload)
    model = build_model(c, fast=True)
    n_frames = int(c["data"]["audio_max_len"] * c["data"]["fs"]) // c["feats"]["hop_length"] + 1
    got = forward_macs(model, n_frames, c["feats"]["n_mels"], c.get("embedding_frames"))
    mine = flops.crnn_macs(c)
    assert mine["macs"] == got["macs"]
    assert mine["by_layer"] == got["by_layer"]


def test_the_2023_count_is_near_the_reference_recipes():
    """917 MMACs against the reference recipe's THOP count of 930.902 for
    the 2023 CRNN on 10 s (THOP also counts some elementwise work)."""
    assert 0.97 < flops.crnn_macs(_config("train_2023_bf16"))["macs"] / 930.902e6 < 1.0


def test_store_and_cache_fills():
    c24, c23 = _config("train_2024_bf16"), _config("train_2023_bf16")
    budget = run.cell_files("train_2024_bf16", run.manifest())["traffic"]["store_bytes"]
    assert budget == 8 << 30
    assert inputs.clip_bytes(c24) == 320_000 + 16_848 + 1_523_712
    assert inputs.clip_bytes(c23) == 326_240
    r24, r23 = inputs.store_rows(c24, budget), inputs.store_rows(c23, budget)
    assert list(r24.values()) == [912, 456, 456, 912, 1824]
    assert list(r23.values()) == [6576, 6576, 13152]
    assert round(sum(r24.values()) * inputs.clip_bytes(c24) / 1e9, 2) == 8.48
    assert round(sum(r23.values()) * inputs.clip_bytes(c23) / 1e9, 2) == 8.58
    clips = run.cell_files("eval_2024_bf16", run.manifest())["traffic"]["clips"]
    assert clips == 1578 - int(1578 * 0.9) and inputs.eval_rows(c24, clips) == 7 * 24
    assert round(inputs.eval_cache_bytes(c24, clips) / 1e9, 3) == 0.310  # padded rows
    # the 2024 DESED validation set (1,168 clips) would not stay resident:
    # build_eval_caches keeps a set on the card only up to 2 GiB
    per_clip = inputs.eval_cache_bytes(c24, clips) / inputs.eval_rows(c24, clips)
    assert round(1168 * per_clip / 1e9, 2) == 2.15  # the clips themselves
    assert inputs.eval_cache_bytes(c24, 1168) > 2 << 30
    clips = run.cell_files("eval_2023_bf16", run.manifest())["traffic"]["clips"]
    assert clips == 1168
    assert round(inputs.eval_cache_bytes(c23, clips) / 1e9, 2) == 0.38
    assert inputs.eval_cache_bytes(c23, clips) < 2 << 30


@pytest.mark.parametrize("workload", ["train_2024_bf16", "eval_2024_bf16",
                                      "train_2023_bf16", "eval_2023_bf16"])
def test_least_times_are_positive_and_bytes_bound(workload):
    files = run.cell_files(workload, run.manifest())
    c, t = files["config"], files["traffic"]
    kind = t["driver"]
    assert roofline.conv_least_s(c, kind, t) > 0
    assert roofline.gru_least_s(c, kind, t) > 0
    assert roofline.peak_flops(c) == 989e12


def test_train_flops_a_clip():
    """About 7.8 GFLOP a clip a 2024 step: 4 forwards and a front end."""
    c = _config("train_2024_bf16")
    per_clip = flops.train_step_flops(c) / 60
    assert 7.0e9 < per_clip < 9.0e9
