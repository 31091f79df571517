"""The port's measuring tools on the CPU: perf/timing (chained runner and
its clock), tools/benchmark (the JAX tool's metric names and keys),
perf/stage_bench, and the two tools that need the card (perf/kernel_bench,
perf/mem_analysis), which must refuse to run without one.  Timings taken
here test the tools; they measure nothing about the card.
"""
import json
import math

import numpy as np
import pytest
import torch

import sift_tpu_torch as stt
from sift_tpu_torch.perf import kernel_bench, mem_analysis, stage_bench
from sift_tpu_torch.perf import timing
from sift_tpu_torch.perf.benchimg import bench_image
from sift_tpu_torch.tools import benchmark


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The frames here are small: one intra-op thread keeps this file off
    the cores of the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_chained_runner_carry_is_bit_identical_to_one_step():
    """k chained steps see the input carry bit for bit (the 1e-30 probe
    fold vanishes on a float32 carry of 0..255 values) and return the
    probe of one step on it."""
    x = torch.from_numpy(np.random.default_rng(0).uniform(
        1, 255, (17, 23)).astype(np.float32))
    seen = []

    def step(c):
        seen.append(c)
        return c * 1.0, (c * c).sum() * 1e3

    probe = timing.chained_runner(step, 5)(x)
    assert len(seen) == 6
    assert all(torch.equal(c, x) for c in seen)
    assert torch.equal(probe, step(x)[1])
    with pytest.raises(ValueError):
        timing.chained_runner(step, 0)


def test_measure_ms_on_a_cpu_tensor():
    """Positive and finite per-iteration ms by the host clock;
    ``on_first_estimate`` hears the first timed run."""
    x = torch.ones(64, 64)
    first = []
    ms = timing.measure_ms(lambda c: (c, (c @ c).sum()), x, k=3, repeats=2,
                           on_first_estimate=first.append)
    assert math.isfinite(ms) and ms > 0
    assert len(first) == 1 and first[0] > 0


class _Clock:
    """A host clock that returns the given readings in turn."""

    def __init__(self, readings):
        self.readings = list(readings)

    def perf_counter(self):
        return self.readings.pop(0)


@pytest.mark.parametrize("readings", [
    [5.0, 5.0],                 # zero span
    [5.0, 4.0],                 # inverted
    [5.0, float("nan")],        # not a number
])
def test_measure_ms_raises_on_a_reading_that_is_not_positive(monkeypatch,
                                                              readings):
    """No slope method and no floor: a zero, inverted or NaN reading
    raises instead of being reported as a time."""
    monkeypatch.setattr(timing, "time", _Clock(readings))
    with pytest.raises(RuntimeError, match="not positive"):
        timing.measure_ms(lambda c: (c, c.sum()), torch.ones(4), k=2,
                          repeats=1)


def test_benchmark_prints_the_jax_tools_metrics(capsys):
    """``tools.benchmark`` at a tiny size on the CPU prints exactly the
    metric names and keys the JAX tool prints for the same flags, every
    value positive and finite, and the detector's own keypoint count."""
    lines = benchmark.main(["--sizes", "128x96", "--num-features", "64",
                            "--batch", "2", "--tiers", "32",
                            "--device", "cpu"])
    printed = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert printed == lines
    full = ["metric", "value", "unit", "keypoints", "vs_baseline"]
    short = ["metric", "value", "unit", "vs_baseline"]
    assert [(ln["metric"], list(ln)) for ln in printed] == [
        ("detect_compute_128x96", full),
        ("detect_compute_128x96_tier32", full),
        ("detect_compute_128x96_batch2", short),
        ("match_2000x2000", short),
    ]
    assert [ln["unit"] for ln in printed] == ["ms", "ms", "ms/frame", "ms"]
    for ln in printed:
        assert math.isfinite(ln["value"]) and ln["value"] > 0
    assert [ln["vs_baseline"] for ln in printed[:3]] == [None] * 3
    assert printed[3]["vs_baseline"] == printed[3]["value"] / 1.0
    det = stt.SiftDetector(stt.SiftConfig(width=128, height=96,
                                          num_features=64), device="cpu")
    count = int(det.detect_and_compute(bench_image(96, 128)).count)
    assert printed[0]["keypoints"] == printed[1]["keypoints"] == count > 0


def test_stage_bench_walks_the_detectors_path(capsys):
    """Eight stage lines in the JAX script's format, and the prefix through
    the orientation expansion computes the detector's own keypoints."""
    rows = stage_bench.main(["128", "96", "64", "--device", "cpu"])
    out = capsys.readouterr().out.splitlines()
    assert len(out) == len(rows) == 8
    for i, (ln, name) in enumerate(zip(out, stage_bench.STAGES), 1):
        assert ln.startswith(f"stage {i} {name:12s} cum ")
        assert ln.rstrip().endswith(" ms") and "delta" in ln
    assert all(r["cum_ms"] > 0 for r in rows)
    cfg = stt.SiftConfig(width=128, height=96, num_features=64)
    img = torch.from_numpy(bench_image(96, 128))
    res = stt.SiftDetector(cfg, device="cpu").detect_and_compute(img)
    probe = stage_bench.build_prefix_fn(stt.build_plan(cfg), 7, "cpu")(img)
    assert torch.equal(probe, res.keypoints.angle.sum()
                       + res.keypoints.x.sum())


@pytest.mark.parametrize("tool", [kernel_bench, mem_analysis],
                         ids=["kernel_bench", "mem_analysis"])
def test_card_tools_refuse_to_run_without_cuda(monkeypatch, tool):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        tool.main([])
