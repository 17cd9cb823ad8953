"""sedbench/spans.py's reduction of a profiled block by the program's own
spans, on a fixture list of Chrome trace events that holds both the
harness's spans ("sedbench.*") and the program's ("desed.*"), a main
thread and an autograd thread: the innermost-span rule across threads,
device time, idle gaps and synchronisations by program span, the
front-end and optimizer/EMA times, the uncovered share of the step; and
sedbench/trace.Trace reads the same with and without the program spans."""

import pytest

from desed_task_tpu_torch.obs.profiling import SPAN_PREFIX
from sedbench import spans
from sedbench.trace import Trace

MAIN, AUTOGRAD = 1, 2


def _span(name, a, b, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": a, "dur": b - a,
            "tid": tid}


def _call(name, ts, corr=None, tid=MAIN):
    e = {"ph": "X", "cat": "cuda_runtime", "name": name, "ts": ts, "dur": 1, "tid": tid,
         "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


def _kernel(name, a, b, corr, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": a, "dur": b - a, "tid": 7,
            "args": {"correlation": corr}}


# (launch ts, launching thread, device start, device end, kernel name)
LAUNCHES = [
    (2, MAIN, 20, 25, "void at::native::index_elementwise_kernel<128, 4>(int)"),
    (13, MAIN, 30, 60, "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize256x128x8"),
    (32, MAIN, 60, 62, "elementwise_kernel"),
    (43, MAIN, 62, 90, "void conv3x3_bf16_fwd_kernel<4>(float const*)"),
    (95, AUTOGRAD, 100, 130, "glu_bwd_frag_kernel"),
    (125, AUTOGRAD, 130, 135, "elementwise_kernel"),
    (152, MAIN, 152, 160, "multi_tensor_apply_kernel"),
    (172, MAIN, 172, 176, "vectorized_elementwise_kernel"),
    (195, MAIN, 300, 302, "elementwise_kernel"),
]
HARNESS = [_span("sedbench.gather", 0, 10), _span("sedbench.step", 10, 200),
           _span("sedbench.fetch", 200, 400)]
PROGRAM = [
    _span("desed.store.gather", 1, 9),
    _span("desed.step", 11, 199),
    _span("desed.frontend.mel", 12, 30),
    _span("desed.step.augment", 31, 40),
    _span("desed.step.student", 41, 80),
    _span("desed.crnn.cnn", 42, 60),
    _span("desed.step.backward", 81, 150),
    _span("desed.cnn.bwd", 91, 120, AUTOGRAD),
    _span("desed.step.optimizer", 151, 170),
    _span("desed.step.ema", 171, 190),
]
OTHER = [
    *(_call("cudaLaunchKernel", ts, corr, tid) for corr, (ts, tid, *_) in enumerate(LAUNCHES)),
    *(_kernel(n, a, b, corr) for corr, (_, _, a, b, n) in enumerate(LAUNCHES)),
    _call("cudaMemcpyAsync", 201, 99), _kernel("Memcpy DtoH", 302, 303, 99, "gpu_memcpy"),
    _call("cudaStreamSynchronize", 165), _call("cudaStreamSynchronize", 202),
    _call("cudaMemcpy", 45),
]
EVENTS = HARNESS + PROGRAM + OTHER


def test_the_program_and_the_benchmark_agree_on_the_prefix():
    assert SPAN_PREFIX == spans.PROGRAM_PREFIX


def test_trace_readers_return_the_same_without_the_program_spans():
    both, harness = Trace(EVENTS, 1, 1.0), Trace(HARNESS + OTHER, 1, 1.0)
    assert both.spans == harness.spans and both.device == harness.device
    assert both.busy_s() == harness.busy_s() and both.merged() == harness.merged()
    assert both.time_s() == harness.time_s()
    assert both.time_s(in_span="gather") == harness.time_s(in_span="gather")
    assert harness.time_s(in_span="gather") == pytest.approx(5e-6)
    assert both.top_ops() == harness.top_ops()
    assert both.idle_by_span() == harness.idle_by_span()


@pytest.mark.parametrize("ts,tid,want", [
    (95, AUTOGRAD, "desed.cnn.bwd"),        # its own thread's span
    (125, AUTOGRAD, "desed.step.backward"),  # none on its thread: the main thread's
    (43, MAIN, "desed.crnn.cnn"),           # the innermost of three
    (195, MAIN, "desed.step"),
    (205, MAIN, ""),                        # only a harness span is open
])
def test_innermost_span_across_threads(ts, tid, want):
    assert spans.ProgramSpans(EVENTS).span_at(ts, tid) == want


def test_device_time_by_program_span():
    got = dict(spans.ProgramSpans(EVENTS).device_by_program_span(20))
    want = {"desed.store.gather": 5, "desed.frontend.mel": 30, "desed.step.augment": 2,
            "desed.crnn.cnn": 28, "desed.cnn.bwd": 30, "desed.step.backward": 5,
            "desed.step.optimizer": 8, "desed.step.ema": 4, "desed.step": 2, "outside": 1}
    assert got.keys() == want.keys()
    assert all(got[k] == pytest.approx(v * 1e-6) for k, v in want.items())


@pytest.mark.parametrize("prefixes,us", [
    (spans.FRONTEND, 30),       # frontend_ms: the DFT GEMM under desed.frontend.mel
    (spans.UPDATE, 12),         # update_ms: the optimizer's and the EMA's kernels
    (("desed.store.gather",), 5),
    (("desed.cnn.bwd", "desed.crnn.cnn"), 58),
])
def test_program_time_by_prefix(prefixes, us):
    assert spans.ProgramSpans(EVENTS).program_time_s(prefixes) == pytest.approx(us * 1e-6)


def test_idle_gaps_by_program_span():
    got = dict(spans.ProgramSpans(EVENTS).idle_by_program_span())
    want = {"desed.frontend.mel": 5, "desed.step.backward": 10 + 17,
            "desed.step.optimizer": 12, "desed.step.ema": 124}
    assert got.keys() == want.keys()
    assert all(got[k] == pytest.approx(v * 1e-6) for k, v in want.items())


def test_host_syncs_by_program_span():
    got = dict(spans.ProgramSpans(EVENTS).syncs_by_program_span())
    assert got == {"desed.step.optimizer": 1, "desed.crnn.cnn": 1, "outside": 1}


def test_uncovered_share_of_the_step():
    ps = spans.ProgramSpans(EVENTS)
    assert ps.uncovered_share("desed.step") == pytest.approx(2 / (30 + 2 + 28 + 30 + 5 + 8
                                                                  + 4 + 2))
    assert ps.uncovered_share("desed.eval") is None


def test_report_per_unit():
    got = spans.report(EVENTS, 2, "train")
    assert got["frontend_ms"] == pytest.approx(1e-3 * 30 / 2)
    assert got["update_ms"] == pytest.approx(1e-3 * 12 / 2)
    assert got["spans_per_unit"] == len(PROGRAM) / 2
    assert got["span_counts"]["desed.step"] == 0.5
    assert dict(got["span_syncs"])["desed.step.optimizer"] == 0.5
    assert spans.report(EVENTS, 1, "eval")["update_ms"] is None


def test_span_cost_reads_each_way_of_calling_span():
    got = spans.span_cost_ns(n=2000, n_profiled=200)
    assert set(got) == {"call", "with", "with_profiled"}
    assert got["with_profiled"] > 0
