"""The program's spans and counters (``perf/telemetry``): absent without a
profiler, one range per detector stage and matcher stage under one, the
results unchanged by them, and the matcher's live-entry counter against a
count made on the host from the masks.
"""
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import sift_tpu_torch as stt
from sift_tpu_torch.perf import profile as perf_profile
from sift_tpu_torch.perf import telemetry as T
from sift_tpu_torch.perf.benchimg import bench_image
from sift_tpu_torch.pipeline.matcher import live_entries

STAGES = ["sift.detect.pyramid", "sift.detect.records", "sift.detect.walk",
          "sift.detect.compact", "sift.detect.orientation",
          "sift.detect.expand", "sift.detect.descriptor"]


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The frames here are small: one intra-op thread keeps this file off
    the cores of the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _fresh_counters():
    T.reset_program_counters()
    yield
    T.reset_program_counters()


@pytest.fixture(scope="module")
def frame():
    return torch.from_numpy(bench_image(96, 128))


def _detector(sigma):
    return stt.SiftDetector(stt.SiftConfig(width=128, height=96,
                                           num_features=64, sigma=sigma),
                            device="cpu")


def _match_inputs(seed=0):
    g = torch.Generator().manual_seed(seed)
    q = torch.randint(0, 256, (40, 128), generator=g).to(torch.uint8)
    t = torch.randint(0, 256, (3, 50, 128), generator=g).to(torch.uint8)
    qv = torch.rand(40, generator=g) < 0.6
    tv = torch.rand(3, 50, generator=g) < 0.4
    return q, t, qv, tv


def _ranges(prof, prefix):
    """(name, start us, end us) of the host-side ranges named
    ``prefix...``, by start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.name.startswith(prefix)),
                  key=lambda r: r[1])


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof


def test_no_profiler_builds_no_range_and_moves_no_counter(monkeypatch,
                                                          frame):
    """Off the profiler a span is one shared no-op context: a detector
    frame and a matcher call build no ``record_function`` and count
    nothing."""
    def refuse(*a, **k):
        raise AssertionError("record_function built without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert not T.tracing()
    assert T.span("a") is T.span("b")
    res = _detector(1.6).detect_and_compute(frame)
    assert int(res.count) > 0
    q, t, qv, tv = _match_inputs()
    stt.match_brute_force(q, t, qv, tv)
    T.count("x", 3)
    T.count_device("y", torch.ones((), dtype=torch.int64))
    assert T.program_counters() == {}


@pytest.mark.parametrize("sigma", [1.6, 1.97], ids=["fused", "flat"])
def test_detector_stage_ranges_nest_in_order(frame, sigma):
    """One ``sift.detect`` range a frame, holding each stage's range once,
    in the pipeline's order, on the fused branch and on the flat one
    (``sigma`` 1.97); the result is bit-identical with the profiler on;
    ``perf/profile.span_rows`` lists the eight ranges once a frame."""
    det = _detector(sigma)
    off = det.detect_and_compute(frame)
    on, prof = _profiled(lambda: det.detect_and_compute(frame))
    for a, b in zip(off.keypoints + (off.descriptors, off.count),
                    on.keypoints + (on.descriptors, on.count)):
        assert torch.equal(a, b)
    ranges = _ranges(prof, "sift.detect")
    (outer, s0, e0), *stages = ranges
    assert outer == "sift.detect"
    assert [n for n, *_ in stages] == STAGES
    for (_, s, e), (_, s_next, _) in zip(stages, stages[1:]):
        assert e <= s_next
    assert all(s0 <= s and e <= e0 for _, s, e in stages)
    rows = perf_profile.span_rows(prof, 1)
    assert [r["span"] for r in rows] == ["sift.detect"] + STAGES
    assert all(r["calls"] == 1 and r["host_ms"] > 0 for r in rows)
    assert T.program_counters() == {}


def test_matcher_ranges_and_result_under_the_profiler():
    """``sift.match`` holds ``.gram``, ``.select`` and ``.count`` in that
    order; the indices are bit-identical with the profiler on."""
    q, t, qv, tv = _match_inputs()
    off = stt.match_brute_force(q, t, qv, tv)
    on, prof = _profiled(lambda: stt.match_brute_force(q, t, qv, tv))
    assert torch.equal(off, on)
    (outer, s0, e0), *inner = _ranges(prof, "sift.match")
    assert outer == "sift.match"
    assert [n for n, *_ in inner] == ["sift.match.gram", "sift.match.select",
                                      "sift.match.count"]
    assert all(s0 <= s and e <= e0 for _, s, e in inner)
    assert T.program_counters() == {
        "match.entries": 3 * 40 * 50,
        "match.live_entries": int(qv.sum()) * int(tv.sum())}


@pytest.mark.parametrize("batched", [True, False],
                         ids=["batched", "unbatched"])
@pytest.mark.parametrize("masks", ["both", "query", "train", "none"])
def test_live_entries_equal_a_host_count(batched, masks):
    """``match.live_entries`` after two calls equals the live query rows
    times the live train rows of each train set, counted on the host from
    the masks (a missing mask: every row of that side); ``match.entries``
    every distance entry."""
    q, t, qv, tv = _match_inputs(seed=3)
    if not batched:
        t, tv = t[1], tv[1]
    qm = qv if masks in ("both", "query") else None
    tm = tv if masks in ("both", "train") else None
    nq = int(qv.sum()) if qm is not None else q.shape[0]
    sets = tv.reshape(-1, tv.shape[-1]) if tm is not None \
        else torch.ones(t.reshape(-1, 50, 128).shape[:2], dtype=torch.bool)
    want = sum(nq * int(row.sum()) for row in sets)
    assert int(live_entries(q, t, qm, tm)) == want
    _profiled(lambda: [stt.match_brute_force(q, t, qm, tm)
                       for _ in range(2)])
    assert T.program_counters() == {
        "match.entries": 2 * q.shape[0] * t.numel() // 128,
        "match.live_entries": 2 * want}
