"""One run of one cell: set-up, the window, the check, the metrics.

``run_cell`` is what ``run.py`` calls on the card; the tests call it on
the CPU at small sizes.  It returns the result line's object without
printing it.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from bench_port import engine, rooflines, spec
from bench_port import trace as tr
from bench_port.reference import octave_shapes


class ReadContext:
    """What a per-layer reader (``metrics/<name>.py``) may read: the cell,
    the parsed trace of the profiled span, the units profiled and the
    host's issue times of the untraced units."""

    def __init__(self, cell: spec.Cell, stream, window: engine.Window,
                 trace):
        self.cell, self.stream, self.window, self.trace = (cell, stream,
                                                           window, trace)
        self.config, self.params = cell.config, cell.params
        self.units = len(window.traced or ())

    @property
    def capacity(self) -> int:
        return int(self.config["sift"]["num_features"])

    def host_issue_ms(self):
        return [s * 1e3 for s in self.window.issue_s]

    def octave_shapes(self):
        """(height, width) of each octave of the configuration."""
        return octave_shapes(int(self.config["width"]),
                             int(self.config["height"]))

    def descriptor_work(self):
        """[(bytes, operations)] of K3 for each profiled frame, counted
        from the live keypoints that the port handed over for it."""
        sift = self.config["sift"]
        shapes = self.octave_shapes()
        plane = sum(h * w for h, w in shapes) \
            * int(sift["num_octave_layers"])
        out = []
        for _, res in self.window.traced or ():
            kp = res.keypoints
            par, rows, count = rooflines.descriptor_rows(
                kp.x, kp.y, kp.octave, kp.size, kp.angle, kp.valid, shapes)
            out.append(rooflines.descriptor_hist_work(plane, par, rows, rows,
                                                      count))
        return out


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool,
             device, t_start: float, prog=None) -> dict:
    """(the result line's object, ``checks`` last; seconds by phase of the
    run).  ``t_start``: the process's start on ``time.perf_counter``'s
    clock."""
    if prog is None:
        import sift_tpu_torch as prog
    cuda = torch.device(device).type == "cuda"
    p = cell.params
    phases = {"start": time.perf_counter() - t_start}

    def phase(name):
        if cuda:
            torch.cuda.synchronize()
        phases[name] = time.perf_counter() - t_start - sum(phases.values())

    stream = spec.stream_class(cell)(cell, seed, device, prog)
    phase("inputs")
    stream.build()
    phase("program")
    stream.prefill()
    phase("prefill")
    engine.run_window(stream, p, math.inf, seed, False,
                      units=int(p["warm_units"]))
    if trace:
        tr.warm_up()
    phase("warm_up")
    setup_s = time.perf_counter() - t_start
    win = engine.run_window(stream, p, seconds, seed, trace)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    stream.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t_check = time.perf_counter()
    numbers = stream.check(win.samples)
    phases["window"] = win.seconds
    phases["check"] = time.perf_counter() - t_check
    checks = {k: {"value": v, "limit": cell.limits[k]}
              for k, v in numbers.items()}
    correct = bool(win.samples) and all(c["value"] <= c["limit"]
                                        for c in checks.values())
    metrics = {}
    last = win.traces[-1] if win.traces else None
    if not trace:
        values = dict(stream.end_to_end(win), setup_s=setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": values[m["name"]],
                                  "unit": m["unit"]}
    elif last is not None:
        ctx = ReadContext(cell, stream, win, last)
        for m in cell.per_layer:
            v = spec.metric_reader(m["name"], cell.home)(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": win.attempted,
           "failed": win.attempted - win.completed, "metrics": metrics,
           "device": dev}
    if trace:
        dev["busy_s"] = last.busy_s if last else 0.0
        dev["window_s"] = last.window_s if last else 0.0
        if last is not None:
            out["breakdown"] = {"device_ops": last.device_ops,
                                "idle_gaps": last.idle_gaps}
    out["checks"] = checks
    return out, phases


def forbidden_modules(names=("jax", "jaxlib", "flax", "sift_tpu")):
    """Loaded modules whose top-level name is one of ``names`` (compared
    whole: ``sift_tpu_torch`` is not ``sift_tpu``)."""
    import sys
    return sorted(m for m in list(sys.modules) if m.split(".")[0] in names)


def check_lines(checks: dict) -> list:
    return [f"check {k}: {c['value']} (limit {c['limit']})"
            for k, c in checks.items()]

