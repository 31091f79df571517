"""Fixtures of the benchmark's tests: tiny cells added as files only, in
a temporary copy of the benchmark's folders.

The tests run on the CPU (``python -m pytest bench_port/tests``); tests
marked ``bench_port_gpu`` need a CUDA device and skip without one, which
a fixture decides, never an import.
"""

import copy
import json
import shutil
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench_port import spec  # noqa: E402

HERE = ROOT / "bench_port"
TINY_CONFIG = "tiny_test_160x120"
TINY_SEQ = "tiny_test_seq3"
TINY_EXH = "tiny_test_exhaustive"
TINY_MIXED = "tiny_test_mixed"
TINY_MIX = "tiny_test_mix"
TINY_GENERATOR = "tiny_test_gen"
TINY_METRIC = "tiny_test_units"


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "bench_port_gpu: needs a CUDA device (skips without one)")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _tiny_files(home: Path):
    base = json.loads((HERE / "configs" / "wvga_752x480.json").read_text())
    cfg = dict(base, name=TINY_CONFIG, width=160, height=120,
               reduced=["width", "height", "num_features"])
    cfg["sift"] = dict(base["sift"], num_features=128)
    seq = {"config": TINY_CONFIG, "traffic": "sequential", "why": "test",
           "params": {"overlap": 3, "views": 8, "warm_units": 1,
                      "trace_units": 2, "trace_kernels": []},
           "limits": {"unpaired": 0.0, "desc_diff": 1, "match_diff": 0}}
    exh = {"config": TINY_CONFIG, "traffic": "exhaustive", "why": "test",
           "params": {"num_sets": 6, "block_size": 3, "pairs_per_call": 5,
                      "live_mean": 40, "live_spread": 5, "shared_share": 0.9,
                      "pool_size": 120,
                      "warm_units": 1, "check_units": 2,
                      "trace_units": 2},
           "limits": {"match_diff": 0}}
    mix = dict(json.loads((HERE / "traffic" / "exhaustive.json")
                          .read_text()), generator=TINY_GENERATOR)
    mixed = dict(exh, traffic=TINY_MIX)
    metric = '"""Units in the profiled span (a test metric)."""\n\n\n' \
             'def read(ctx):\n    return float(ctx.units) or None\n'
    generator = ('"""A test generator: the exhaustive one, found by '
                 'name."""\n\nfrom pathlib import Path\n\n'
                 'from bench_port import spec\n\n'
                 'Base = spec.load_module(Path(__file__).with_name('
                 '"exhaustive.py"), "test").Stream\n\n\n'
                 'class Stream(Base):\n    pass\n')
    return {
        home / "configs" / f"{TINY_CONFIG}.json": json.dumps(cfg),
        home / "workloads" / f"{TINY_SEQ}.json": json.dumps(seq),
        home / "workloads" / f"{TINY_EXH}.json": json.dumps(exh),
        home / "workloads" / f"{TINY_MIXED}.json": json.dumps(mixed),
        home / "traffic" / f"{TINY_MIX}.json": json.dumps(mix),
        home / "generators" / f"{TINY_GENERATOR}.py": generator,
        home / "metrics" / f"{TINY_METRIC}.py": metric,
    }


class Tiny:
    """A checkout in a temporary folder: ``BENCHMARK.json`` (``bench``)
    with three tiny cells, a configuration, a mix, a generator and a
    metric added, their files written beside copies of the benchmark's
    own under ``home``."""

    def __init__(self, tmp: Path):
        self.root, self.home = tmp, tmp / "bench_port"
        for d in ("configs", "traffic", "workloads", "metrics",
                  "generators"):
            shutil.copytree(HERE / d, self.home / d,
                            ignore=shutil.ignore_patterns("__pycache__"))
        for path, text in _tiny_files(self.home).items():
            path.write_text(text)
        bench = copy.deepcopy(spec.load_benchmark())
        bench["configs"].append({"name": TINY_CONFIG, "source": "test",
                                 "file": f"bench_port/configs/"
                                         f"{TINY_CONFIG}.json",
                                 "reduced": [], "why": "test"})
        for name, mix in ((TINY_SEQ, "sequential"), (TINY_EXH, "exhaustive"),
                          (TINY_MIXED, TINY_MIX)):
            bench["workloads"].append({"name": name, "config": TINY_CONFIG,
                                       "traffic": mix, "chips": 1,
                                       "why": "test"})
        rate = {"frames_per_s": [TINY_SEQ],
                "match_pairs_per_s": [TINY_EXH, TINY_MIXED]}
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m:
                m["workloads"] += rate.get(m.get("moves", m["name"]), [])
        bench["per_layer"].append({"name": TINY_METRIC, "unit": "units",
                                   "better": "higher",
                                   "source": "device_trace",
                                   "layer": "device", "moves": "frames_per_s",
                                   "workloads": [TINY_SEQ]})
        self.bench = bench

    def cell(self, name):
        return spec.load_cell(name, self.bench, self.root, self.home)


@pytest.fixture
def tiny(tmp_path):
    return Tiny(tmp_path)
