"""Frames detected and matched against the ``overlap`` frames before.

Each rendered view is detected and described by
``SiftDetector.detect_and_compute`` and matched, in ONE
``match_brute_force`` call, against the ``overlap`` frames before it (a
ring of their descriptors and valid masks, filled before the window);
then its descriptors take the oldest frame's place in the ring.  A unit
is a frame.  (COLMAP's sequential matcher.)  Reports ``frames_per_s``.
"""

from __future__ import annotations

import collections
import time

import numpy as np
import torch

from bench_port import inputs
from bench_port.engine import Sample, record
from bench_port.reference import PlainSift, match_exact
from bench_port.reference.compare import FIELDS, detector_gaps


def keypoint_fields(res) -> dict:
    """Host copy of a detector result's keypoints (``compare.FIELDS``)."""
    return {f: getattr(res.keypoints, f).detach().cpu().numpy()
            for f in FIELDS}


class Stream:
    def __init__(self, cell, seed: int, device, prog):
        p, c = cell.params, cell.config
        self.prog, self.device = prog, device
        self.w, self.h = int(c["width"]), int(c["height"])
        self.sift = dict(c["sift"])
        self.ratio = float(c["match_ratio"])
        self.frames = inputs.rendered_views(
            self.h, self.w, p, inputs.generator(seed, device), device)
        self.k = int(p["overlap"])
        self.cap = int(self.sift["num_features"])
        self.out_shape = (self.k, self.cap)
        self.units_per_call = 1
        self.match_sets = (self.k, 1)
        self.traced = None          # (frame, result) of the profiled units
        self.refs = {}              # the plain detector by precision

    def view(self, f):
        return self.frames[f % len(self.frames)]

    def build(self):
        """The program's detector and the empty ring."""
        k, cap = self.out_shape
        self.det = self.prog.SiftDetector(
            self.prog.SiftConfig(width=self.w, height=self.h, **self.sift),
            device=self.device)
        self.ring_desc = torch.zeros((k, cap, 128), dtype=torch.uint8,
                                     device=self.device)
        self.ring_valid = torch.zeros((k, cap), dtype=torch.bool,
                                      device=self.device)
        self.ring_frame = [-1] * k
        self.recent = collections.deque(maxlen=k + 1)
        self.next_frame = 0

    def prefill(self):
        """The ring's frames, detected before the window."""
        for _ in range(self.k):
            f = self.next_frame
            self.next_frame += 1
            self.store(f, self.det.detect_and_compute(self.view(f)))

    def store(self, f, res):
        s = f % self.k
        self.ring_desc[s].copy_(res.descriptors)
        self.ring_valid[s].copy_(res.keypoints.valid)
        self.ring_frame[s] = f
        self.recent.append((f, res))

    def issue(self, buf, keep: bool):
        """Enqueue one frame; returns (host seconds of the detector call,
        what a kept unit needs for its check, or None)."""
        f = self.next_frame
        self.next_frame += 1
        with record("detect"):
            t0 = time.perf_counter()
            res = self.det.detect_and_compute(self.view(f))
            issue_s = time.perf_counter() - t0
        with record("match"):
            idx = self.prog.match_brute_force(
                res.descriptors, self.ring_desc, res.keypoints.valid,
                self.ring_valid, self.ratio)
        with record("copy_out"):
            buf.copy_(idx, non_blocking=True)
        meta = None
        if keep:
            with record("keep"):
                meta = dict(frame=f, result=res,
                            ring_desc=self.ring_desc.clone(),
                            ring_valid=self.ring_valid.clone(),
                            ring_frame=list(self.ring_frame),
                            ring_results=dict(self.recent))
        if self.traced is not None:
            self.traced.append((f, res))
        with record("ring"):
            self.store(f, res)
        return issue_s, meta

    def release(self):
        """Free the program's state (the kept samples stay)."""
        del self.det, self.ring_desc, self.ring_valid
        self.recent.clear()

    def end_to_end(self, win) -> dict:
        return {"frames_per_s": win.completed / win.seconds}

    def plain(self, g, precision: str, cache: dict):
        """The plain detector's result on frame ``g`` at ``precision``,
        kept in ``cache`` by view."""
        key = (precision, g % len(self.frames))
        if key not in cache:
            if precision not in self.refs:
                self.refs[precision] = PlainSift(self.w, self.h, self.sift,
                                                 self.device, precision)
            cache[key] = self.refs[precision](self.view(g))
        return cache[key]

    def outputs(self, s: Sample, control=None, cache=None):
        """For a kept frame: {frame: (keypoints, descriptors)} of every
        frame its indices involve (the query and the ring's frames), the
        query's descriptors and mask, the ring's, and the indices.  With
        ``control`` = (a precision of the plain detector, the descriptors
        it reports as a function of its own, what its matcher reads of
        those) put in the program's place, all of it is the control's:
        the plain detector's keypoints and descriptors at that precision,
        and the exact matcher's indices on what it reads."""
        m = s.meta
        if control is None:
            frames = {m["frame"]: (keypoint_fields(m["result"]),
                                   m["result"].descriptors.cpu().numpy())}
            for slot, g in enumerate(m["ring_frame"]):
                if g >= 0:
                    frames[g] = (keypoint_fields(m["ring_results"][g]),
                                 m["ring_desc"][slot].cpu().numpy())
            return (frames, m["result"].descriptors,
                    m["result"].keypoints.valid, m["ring_desc"],
                    m["ring_valid"], s.indices)
        precision, reported, read = control
        ids = [m["frame"]] + [g for g in m["ring_frame"] if g >= 0]
        frames, padded = {}, {}
        for g in ids:
            r = self.plain(g, precision, cache)
            d, v = r.padded(self.cap, self.device)
            d = reported(d)
            padded[g] = (d, v)
            frames[g] = (r.fields, d[:len(r.descriptors)].cpu().numpy())
        qd, qv = padded[m["frame"]]
        none = (torch.zeros_like(qd), torch.zeros_like(qv))
        rd = torch.stack([padded.get(g, none)[0] for g in m["ring_frame"]])
        rv = torch.stack([padded.get(g, none)[1] for g in m["ring_frame"]])
        idx = np.stack([match_exact(read(qd), read(rd[j]), qv, rv[j],
                                    self.ratio).cpu().numpy()
                        for j in range(rd.shape[0])])
        return frames, qd, qv, rd, rv, idx

    def check(self, samples, control=None, cache=None) -> dict:
        """The numbers compared, over every frame the kept frames involve:
        the share of keypoints left unpaired against the plain reference
        detector and the largest paired descriptor difference; and the
        query indices that differ from the exact matcher's over the same
        descriptors.  ``cache``: the reference's results by view, kept
        between calls."""
        cache = {} if cache is None else cache
        unpaired, ddiff, mdiff = 0.0, 0, 0
        for s in samples:
            frames, qd, qv, rd, rv, idx = self.outputs(s, control, cache)
            for g, (kp, desc) in frames.items():
                r = self.plain(g, "float64", cache)
                u, d = detector_gaps(kp, desc, r.fields, r.descriptors)
                unpaired, ddiff = max(unpaired, u), max(ddiff, d)
            for j in range(rd.shape[0]):
                want = match_exact(qd, rd[j], qv, rv[j], self.ratio)
                mdiff += int((want.cpu().numpy() != idx[j]).sum())
        return {"unpaired": unpaired, "desc_diff": ddiff,
                "match_diff": mdiff}
