"""The program's spans in a hand-written trace (``spans.Program``), the
harness's own parse unchanged by them, and the readers of the program's
counters."""

import json
import types

import pytest
import torch

import sift_tpu_torch
from bench_port import spans, spec
from bench_port import trace as tr

from conftest import HERE


def _range(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "pid": 1, "tid": tid}


def _launch(corr, ts, dur, cat="cuda_runtime"):
    return {"ph": "X", "cat": cat, "name": "cudaLaunchKernel", "ts": ts,
            "dur": dur, "pid": 1, "tid": 1, "args": {"correlation": corr}}


def _device(corr, name, ts, end, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": end - ts,
            "pid": 0, "tid": 7, "args": {"correlation": corr}}


PROGRAM = [
    _range("sift.detect", 5, 90),
    _range("sift.detect.pyramid", 10, 30),
    _range("sift.detect.records", 45, 35),
    _range("sift.match", 105, 85),
    _range("sift.match.gram", 110, 20),
    _range("sift.match.select", 135, 35),
    _range("sift.match.count", 175, 10),
]
HARNESS = [
    _range("bench.detect", 0, 100), _range("bench.match", 100, 100),
    _range("bench.copy_out", 200, 10),
    # Still on the device when the profile began: its launch is not here.
    _device(99, "before", -10, -5),
    _launch(1, 12, 3), _device(1, "gemm_a", 20, 30),
    _launch(2, 20, 15), _device(2, "elementwise_a", 32, 36),
    _launch(3, 50, 2, "cuda_driver"),
    _device(3, "detect_records_kernel", 60, 70),
    # Launched in sift.detect between its stages.
    _launch(4, 82, 4), _device(4, "fill", 85, 90),
    _launch(5, 112, 2), _device(5, "gemm_b", 115, 150),
    _launch(6, 140, 2), _device(6, "min_kernel", 150, 160),
    _launch(7, 150, 2), _device(7, "where", 160, 165),
    _launch(8, 178, 1), _device(8, "sum", 178, 180),
    _launch(9, 202, 1), _device(9, "Memcpy DtoH", 205, 207, "gpu_memcpy"),
]


def test_the_program_parse_of_a_hand_written_trace():
    """Kernels and device time by the innermost span that launched them,
    host and self time, idle gaps by the span the host was in when they
    opened, time in CUDA API calls."""
    p = spans.Program(HARNESS + PROGRAM)
    assert set(p.calls.values()) == {1} and len(p.calls) == 7
    assert p.host_us["sift.detect"] == 90
    assert p.self_us["sift.detect"] == 90 - 30 - 35
    assert p.self_us["sift.match"] == 85 - 20 - 35 - 10
    assert dict(p.device_us) == {
        "sift.detect.pyramid": 14, "sift.detect.records": 10,
        "sift.detect": 5, "sift.match.gram": 35, "sift.match.select": 15,
        "sift.match.count": 2}
    assert p.kernel_count["sift.detect.pyramid"] == 2
    assert [k[0] for k in p.kernels][0] == "gemm_a"
    assert dict(p.runtime_us) == {
        "sift.detect.pyramid": 18, "sift.detect.records": 2,
        "sift.detect": 4, "sift.match.gram": 2, "sift.match.select": 4,
        "sift.match.count": 1}
    assert dict(p.idle_us) == {
        "sift.detect.pyramid": 2 + 24, "sift.detect.records": 15,
        "sift.detect": 25, "sift.match.select": 13, "sift.match.count": 25}
    got = spans.span_metrics(p)
    want = {"detect_glue_ms": 0.019, "detect_idle_ms": 0.066,
            "detect_launch_wait_ms": 0.024, "match_gram_ms": 0.035,
            "match_select_ms": 0.015, "match_count_ms": 0.002}
    assert got == pytest.approx(want)
    row = p.table(1)["sift.detect.pyramid"]
    assert row == pytest.approx({"calls": 1, "host_ms": 0.030,
                                 "self_ms": 0.030, "kernels": 2,
                                 "device_ms": 0.014, "idle_ms": 0.026,
                                 "runtime_ms": 0.018})


def test_the_harness_parse_is_the_same_with_and_without_the_spans():
    a, b = tr.Trace(HARNESS + PROGRAM), tr.Trace(HARNESS)
    for key in ("kernels", "busy_s", "window_s", "device_ops",
                "idle_gaps"):
        assert getattr(a, key) == getattr(b, key), key
    assert a.kernel_count(where="bench.detect") == 4


def test_every_span_reading_is_none_without_the_programs_spans():
    p = spans.Program(HARNESS)
    assert not p.calls and not p.device_us
    assert set(spans.span_metrics(p).values()) == {None}


def _ctx(prog, events=HARNESS):
    return types.SimpleNamespace(stream=types.SimpleNamespace(prog=prog),
                                 trace=tr.Trace(events))


@pytest.fixture
def counters():
    tel = sift_tpu_torch.perf.telemetry
    tel.reset_program_counters()
    yield tel
    tel.reset_program_counters()


def test_the_live_share_reads_the_programs_counters(counters):
    """The share after two profiled matcher calls, one batched; None from
    a program without counters, from a trace without the matcher's
    kernels, and before any call was counted."""
    g = torch.Generator().manual_seed(5)
    q = torch.randint(0, 256, (30, 128), generator=g).to(torch.uint8)
    t = torch.randint(0, 256, (2, 40, 128), generator=g).to(torch.uint8)
    qv, tv = torch.rand(30, generator=g) < 0.5, torch.rand(2, 40,
                                                          generator=g) < 0.3
    assert spans.live_share(_ctx(sift_tpu_torch)) is None
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        sift_tpu_torch.match_brute_force(q, t, qv, tv)
        sift_tpu_torch.match_brute_force(q, t[0], None, tv[0])
    live = int(qv.sum()) * int(tv.sum()) + 30 * int(tv[0].sum())
    assert spans.live_share(_ctx(sift_tpu_torch)) == pytest.approx(
        100.0 * live / (2 * 30 * 40 + 30 * 40))
    assert spans.live_share(_ctx(sift_tpu_torch, HARNESS[:3])) is None
    parent = types.ModuleType("parent_prog")
    assert spans.live_share(_ctx(parent)) is None


def test_the_new_metrics_have_their_readers():
    bench = spec.load_benchmark()
    new = {m["name"]: m for m in bench["per_layer"]
           if m["name"].startswith("match_live_share.")}
    assert set(new) == {"match_live_share.frames", "match_live_share.pairs"}
    for name, m in new.items():
        assert (HERE / "metrics" / f"{name}.py").exists()
        assert spec.metric_reader(name) is spans.live_share
        assert m["source"] == "program_counter" and m["unit"] == "%"
    assert new["match_live_share.frames"]["workloads"] == ["uhd_seq10"]
    assert json.dumps(new["match_live_share.pairs"]["workloads"]) == \
        '["uhd_exhaustive50", "wvga_exhaustive50"]'
