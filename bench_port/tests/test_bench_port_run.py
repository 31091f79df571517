"""Whole runs of tiny cells on the CPU: the harness measures, traces and
checks; each fault planted under the timed path turns ``correct`` false,
and so does the control; ``run.py`` refuses to run without the device or
the program."""

import json
import shutil
import subprocess
import sys
import time
import types

import pytest
import torch

import sift_tpu_torch
from bench_port import control, engine, measure, spec

from conftest import HERE, ROOT, TINY_EXH, TINY_METRIC, TINY_MIXED, TINY_SEQ

SEED = 2**31 + 11


def _run(tiny, name, trace=False, prog=None, seconds=0.5, seed=SEED):
    cell = tiny.cell(name)
    out, _ = measure.run_cell(cell, seed, seconds, trace, "cpu",
                              time.perf_counter(), prog=prog)
    return out


def _prog(match=None, detector=None):
    return types.SimpleNamespace(
        SiftConfig=sift_tpu_torch.SiftConfig,
        SiftDetector=detector or sift_tpu_torch.SiftDetector,
        match_brute_force=match or sift_tpu_torch.match_brute_force)


@pytest.mark.parametrize("name", [TINY_SEQ, TINY_EXH, TINY_MIXED])
def test_a_sound_run_is_correct_and_reports_the_cells_metrics(tiny,
                                                               name):
    out = _run(tiny, name)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    rate = "frames_per_s" if name == TINY_SEQ else "match_pairs_per_s"
    assert set(out["metrics"]) == {rate, "setup_s"}
    assert all(c["value"] <= c["limit"] for c in out["checks"].values())


def test_a_traced_run_reads_the_layer_metrics(tiny):
    out = _run(tiny, TINY_SEQ, trace=True, seconds=1.5)
    assert out["correct"] is True
    # No device here: the trace has no kernels, so only the host's and
    # the test metric's readers find something to read; the profile ran
    # its whole span.
    assert set(out["metrics"]) == {"host_issue_ms.frames", TINY_METRIC}
    assert out["metrics"][TINY_METRIC]["value"] == 2
    assert {"busy_s", "window_s"} <= set(out["device"])
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def _half_batch(q, t, qv, tv, ratio):
    """Matches only the first half of the train sets; the rest unmatched."""
    out = sift_tpu_torch.match_brute_force(q, t, qv, tv, ratio)
    out[t.shape[0] // 2:] = -1
    return out


def _altered(q, t, qv, tv, ratio):
    """One answer altered where it is produced."""
    out = sift_tpu_torch.match_brute_force(q, t, qv, tv, ratio)
    i = int(torch.nonzero(out.reshape(-1) >= 0)[0])
    out.view(-1)[i] = (out.view(-1)[i] + 1) % t.shape[-2]
    return out


def _unchanged():
    """A step that returns the state it was given: every call answers
    what the first call did."""
    first = []

    def match(q, t, qv, tv, ratio):
        if not first:
            first.append(sift_tpu_torch.match_brute_force(q, t, qv, tv,
                                                          ratio))
        return first[0].clone()
    return match


class _AlteredDescriptor(sift_tpu_torch.SiftDetector):
    """One descriptor entry of every frame altered where it is produced."""

    def detect_and_compute(self, image):
        r = super().detect_and_compute(image)
        d = r.descriptors.clone()
        d[0, 0] = (d[0, 0].to(torch.int32) + 40).clamp(max=255).to(d.dtype)
        return r._replace(descriptors=d)


@pytest.mark.parametrize("name", [TINY_SEQ, TINY_EXH])
@pytest.mark.parametrize("fault", ["half_batch", "altered_answer",
                                   "state_unchanged"])
def test_a_fault_under_the_timed_path_is_not_correct(tiny, name,
                                                     fault):
    match = {"half_batch": _half_batch, "altered_answer": _altered,
             "state_unchanged": _unchanged()}[fault]
    out = _run(tiny, name, prog=_prog(match=match))
    assert out["correct"] is False, out["checks"]


def test_a_ring_left_unchanged_is_not_correct(tiny, monkeypatch):
    """The sequential mix's state: the ring's descriptors never written."""
    def store(self, f, res):
        self.ring_frame[f % self.k] = f
        self.recent.append((f, res))
    monkeypatch.setattr(spec.stream_class(tiny.cell(TINY_SEQ)), "store",
                        store)
    out = _run(tiny, TINY_SEQ)
    assert out["correct"] is False
    assert out["checks"]["desc_diff"]["value"] > 0


def test_an_altered_descriptor_is_not_correct(tiny):
    out = _run(tiny, TINY_SEQ,
               prog=_prog(detector=_AlteredDescriptor))
    assert out["correct"] is False
    assert out["checks"]["desc_diff"]["value"] >= 40


def _window(tiny, name, seconds=0.3, device="cpu"):
    cell = tiny.cell(name)
    stream = spec.stream_class(cell)(cell, SEED, device, sift_tpu_torch)
    stream.build()
    stream.prefill()
    win = engine.run_window(stream, cell.params, seconds, SEED, False)
    return cell, stream, win


def test_the_int4_control_is_not_correct(tiny):
    """The exhaustive mix's control: the reference on descriptors kept at
    4 bits, in the program's place."""
    cell, stream, win = _window(tiny, TINY_EXH)
    assert stream.check(win.samples)["match_diff"] == 0
    ctl = control.controls(cell)
    assert set(ctl) == {"int4_match"}
    assert stream.check(win.samples, control=ctl["int4_match"])[
        "match_diff"] > cell.limits["match_diff"]


@pytest.mark.parametrize("name", ["tf32", "int4_descriptors", "int4_match"])
def test_the_sequential_controls_are_not_correct(tiny, name):
    """The sequential mix's controls, each in the program's place: the
    plain detector with its blurs in TF32, its descriptors reported at 4
    bits, and its matcher reading them at 4 bits."""
    cell, stream, win = _window(tiny, TINY_SEQ)
    cache = {}
    sound = stream.check(win.samples, cache=cache)
    assert all(sound[k] <= cell.limits[k] for k in sound), sound
    ctl = stream.check(win.samples, control=control.controls(cell)[name],
                       cache=cache)
    failed = {k for k in ctl if ctl[k] > cell.limits[k]}
    assert failed >= {"tf32": {"unpaired"}, "int4_match": {"match_diff"},
                      "int4_descriptors": {"desc_diff"}}[name], ctl


@pytest.mark.bench_port_gpu
@pytest.mark.parametrize("name", [TINY_SEQ, TINY_EXH])
def test_tiny_cells_on_the_card(gpu, tiny, name):
    cell = tiny.cell(name)
    out, _ = measure.run_cell(cell, SEED, 1.0, True, gpu,
                              time.perf_counter())
    assert out["correct"] is True
    assert out["device"]["busy_s"] > 0
    assert 0 < out["device"]["busy_s"] <= out["device"]["window_s"]


def test_run_refuses_without_the_device_or_the_program(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without CUDA")
    cmd = [sys.executable, "bench_port/run.py", "--workload", "uhd_seq10",
           "--seed", str(SEED), "--seconds", "1", "--trace", "0"]
    r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True)
    assert r.returncode != 0 and r.stdout == ""
    # A directory with only BENCHMARK.json and the benchmark's folder.
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(HERE, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True)
    assert r.returncode != 0 and r.stdout == ""
    assert "sift_tpu_torch" in r.stderr
    json.loads((tmp_path / "BENCHMARK.json").read_text())
