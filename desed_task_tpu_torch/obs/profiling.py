"""Profiling helpers (counterpart of desed_task_tpu/obs/profiling.py).

- `trace(log_dir)`: a context manager around torch.profiler.profile, CPU
  activity always and CUDA activity when the card is in use. On exit it
  writes a Chrome trace (`trace.json`, viewable in Perfetto or
  chrome://tracing) under `log_dir`; its CUDA events name each kernel.
- `span(name)`: a named host span of the program, "desed.<name>", recorded
  by whichever torch.profiler is running, on the same clock as the
  kernels it launches. With no profiler running it is one shared no-op
  context: no tensor, no device work, no synchronisation, and a check
  that costs a fraction of a microsecond.

The spans, from the outside in (each in the module that does the work):

    desed.step                  mean_teacher.make_train_step's optimizer step
      desed.step.augment        frame shift, noise, the mixup gate and draws, mixup
      desed.step.teacher        the teacher's forward (no grad)
      desed.step.student        the student's forward
      desed.step.loss           the supervised and consistency losses
      desed.step.backward       total.backward()
        desed.cnn.bwd           the conv blocks' backward kernels (autograd thread)
        desed.rnn.bwd           the BiGRU's backward kernel (autograd thread)
      desed.step.optimizer      clip by global norm + Adam
      desed.step.ema            the teacher's EMA update
    desed.frontend.mel          framing, DFT and the mel product (any caller)
    desed.frontend.db           amplitude to dB
    desed.frontend.scaler       the feature scaler
    desed.crnn.cnn              SpecAugment and the conv blocks (any caller)
    desed.crnn.embed            the embeddings' aggregation and fusion (cat_tf)
    desed.crnn.rnn              the recurrent layers and their dropout
    desed.crnn.heads            the strong and weak heads
    desed.store.gather          the device store's row gather (train batches)
    desed.eval                  one forward pass over a device-resident eval set
      desed.eval.median         the class-wise median filter
      desed.eval.copy           the stacked scores' one copy to the host
"""

from __future__ import annotations

import contextlib
from pathlib import Path

import torch

TRACE_FILE = "trace.json"
SPAN_PREFIX = "desed."
_OFF = contextlib.nullcontext()
_profiler_on = torch._C._autograd._profiler_enabled  # this thread's profiler state


def span(name: str):
    """`with span("step.optimizer"):` records "desed.step.optimizer" when a
    torch.profiler is running on this thread (the autograd engine's threads
    inherit it), else does nothing."""
    if _profiler_on():
        return torch.profiler.record_function(SPAN_PREFIX + name)
    return _OFF


@contextlib.contextmanager
def trace(log_dir):
    """Profile the block; writes `<log_dir>/trace.json`. The card's activity
    is traced too when CUDA is available. The program's spans (`span`)
    appear as user annotations on the host threads that entered them."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out = Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(out / TRACE_FILE))
