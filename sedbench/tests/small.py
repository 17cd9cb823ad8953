"""A cell of the benchmark cut to a size that a CPU test holds: 1-second
clips, 50 embedding frames, two clips a slot (eight for the eval set),
the published widths and every other key as the cell has them."""

from __future__ import annotations

import copy

from sedbench import inputs, run


def small_files(workload: str, clips_per_slot: int = 2) -> dict:
    bench = run.manifest()
    files = copy.deepcopy(run.cell_files(workload, bench))
    c, t = files["config"], files["traffic"]
    c["data"]["audio_max_len"] = 1
    if "embedding_frames" in c:
        c["embedding_frames"] = 50
    for s in c["slots"]:
        s["size"] = clips_per_slot
    c["training"]["batch_size_val"] = 4
    if t["driver"] == "train":
        t.update(store_bytes=4 * sum(s["size"] for s in c["slots"]) * inputs.clip_bytes(c),
                 warmup_steps=1, trace_steps=2)
    else:
        t.update(clips=8, warmup_passes=1, trace_passes=1, reference_block=4)
    return files

