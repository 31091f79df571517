"""Every pair of a collection's descriptor sets, in block order.

``num_sets`` descriptor sets (``inputs.landmark_sets``), every pair of
them in the block order of COLMAP's exhaustive matcher (``block_size``),
``pairs_per_call`` pairs to one ``match_brute_force`` call, cycling
through the pairs.  A unit is a call.  Reports ``match_pairs_per_s``.
"""

from __future__ import annotations

import numpy as np
import torch

from bench_port import inputs
from bench_port.engine import Sample, record
from bench_port.reference import match_exact


def exhaustive_pairs(n: int, block: int):
    """(i, j) pairs, i < j, in COLMAP's exhaustive block order: blocks of
    ``block`` images, every pair of blocks (b1 <= b2) in turn."""
    out = []
    for b1 in range(0, n, block):
        for b2 in range(b1, n, block):
            for i in range(b1, min(b1 + block, n)):
                for j in range(b2, min(b2 + block, n)):
                    if j > i:
                        out.append((i, j))
    return out


class Stream:
    def __init__(self, cell, seed: int, device, prog):
        p, c = cell.params, cell.config
        self.prog, self.device = prog, device
        self.ratio = float(c["match_ratio"])
        cap = int(c["sift"]["num_features"])
        self.desc, self.valid = inputs.landmark_sets(
            cap, p, inputs.generator(seed, device), device)
        pairs = exhaustive_pairs(int(p["num_sets"]), int(p["block_size"]))
        ppc = int(p["pairs_per_call"])
        if len(pairs) % ppc:
            raise ValueError(f"{len(pairs)} pairs do not fill calls of "
                             f"{ppc}")
        self.pairs = pairs
        self.pair_idx = torch.tensor(pairs, dtype=torch.int64,
                                     device=device).view(-1, ppc, 2)
        self.calls = 0
        self.out_shape = (ppc, cap)
        self.units_per_call = ppc
        self.match_sets = (ppc, ppc)
        self.traced = None          # the profiled calls

    def build(self):
        pass

    def prefill(self):
        pass

    def issue(self, buf, keep: bool):
        c = self.calls % self.pair_idx.shape[0]
        self.calls += 1
        with record("gather"):
            qi, ti = self.pair_idx[c, :, 0], self.pair_idx[c, :, 1]
            q, t = self.desc[qi], self.desc[ti]
            qv, tv = self.valid[qi], self.valid[ti]
        with record("match"):
            idx = self.prog.match_brute_force(q, t, qv, tv, self.ratio)
        with record("copy_out"):
            buf.copy_(idx, non_blocking=True)
        if self.traced is not None:
            self.traced.append(c)
        return 0.0, (dict(call=c) if keep else None)

    def release(self):
        pass

    def end_to_end(self, win) -> dict:
        return {"match_pairs_per_s": win.completed / win.seconds}

    def outputs(self, s: Sample, control=None):
        """(pairs, indices) of a kept call; ``control`` = (a precision,
        the descriptors reported, what the matcher reads of them: see
        ``control.py``) computes the indices in the program's place with
        the exact matcher on what it reads of the sets (the sets are the
        benchmark's own: no detector runs)."""
        c = s.meta["call"]
        pairs = self.pairs[c * self.units_per_call:
                           (c + 1) * self.units_per_call]
        if control is None:
            return pairs, s.indices
        read = control[2]
        idx = np.stack([match_exact(read(self.desc[i]), read(self.desc[j]),
                                    self.valid[i], self.valid[j],
                                    self.ratio).cpu().numpy()
                        for i, j in pairs])
        return pairs, idx

    def check(self, samples, control=None, cache=None) -> dict:
        """The number compared: the indices, over every kept pair, that
        differ from the exact matcher's on the same descriptor sets."""
        mdiff = 0
        for s in samples:
            pairs, idx = self.outputs(s, control)
            for row, (i, j) in enumerate(pairs):
                want = match_exact(self.desc[i], self.desc[j], self.valid[i],
                                   self.valid[j], self.ratio)
                mdiff += int((want.cpu().numpy() != idx[row]).sum())
        return {"match_diff": mdiff}
