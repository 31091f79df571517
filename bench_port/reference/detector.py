"""A plain SIFT detector, written from the algorithm's definition.

Lowe's SIFT as OpenCV's ``cv::SIFT`` computes it, with the settings a
configuration's ``sift`` group states.  Every stage is the textbook loop
made into tensor arithmetic, in float64:

1. the octave base: the image blurred by ``sqrt(sigma^2 - 4 * 0.5^2)``
   (at least 0.1); each later octave's base is layer ``L`` of the octave
   before, every second pixel of every second row;
2. the Gaussian layers: a chain of separable blurs, each a 1-D kernel of
   ``round(truncate * s + 1) | 1`` normalised taps with the border mirrored
   without repeating the edge pixel (reflect-101), and their differences;
3. extrema: a difference pixel at least ``border`` pixels inside the
   image, above ``floor(0.5 * contrast / L * 255)`` in magnitude, and at
   least as large (or as small) as its 26 neighbours across three layers;
4. refinement: up to five Newton steps on the 3-D quadratic of the
   differences (derivatives on the 0..1 scale), moving to the nearest
   pixel and layer while the offset reaches half a step; then the contrast
   and edge (principal curvature ratio) tests at the final point;
5. orientation: a 36-bin histogram of gradient directions on the
   keypoint's Gaussian layer, Gaussian weighted (sigma 1.5 scale, radius
   3 sigma), smoothed by (1 4 6 4 1)/16, a keypoint for every local
   maximum of at least 0.8 of the highest, its bin refined by a parabola;
6. the descriptor: gradients in the rotated 4 x 4 grid of cells 3 scale
   wide, Gaussian weighted, spread over cells and 8 orientation bins by
   trilinear interpolation, normalised, clipped at 0.2 and normalised
   again, times 512, rounded and saturated to a byte.

The configuration's fixed capacities hold as its ``num_features``
states them: candidates are kept in scan order (octave, layer, row,
column) up to each octave's candidate capacity and twice
``num_features`` in all, keypoints in that order up to ``num_features``,
and oriented keypoints (keypoint by keypoint, bins in ascending order)
up to ``num_features``.

``precision="tf32"`` is the control: every blur's image and taps are
rounded to TF32 (10 bits of mantissa) and summed in float32, the nearest
precision below the float32 with TF32 off that the configuration states;
the rest runs in float32.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

BORDER = 5
MAX_STEPS = 5
INIT_SIGMA = 0.5
ORI_BINS = 36
ORI_SIG_FCTR = 1.5
ORI_RADIUS = 3.0 * ORI_SIG_FCTR
ORI_PEAK_RATIO = 0.8
DESCR_WIDTH = 4
DESCR_BINS = 8
DESCR_SCL_FCTR = 3.0
DESCR_MAG_THR = 0.2
INT_DESCR_FCTR = 512.0
FLT_EPSILON = 1.192092896e-07
CHUNK = 1024                    # keypoints per descriptor block


def num_octaves(width: int, height: int) -> int:
    """round(log2(min(2W, 2H)) - 2) + 1."""
    return int(round(math.log2(min(2 * width, 2 * height)) - 2.0)) + 1


def octave_shapes(width: int, height: int):
    """(h, w) of each octave: the image, then halved (floor) each time."""
    h, w, out = height, width, []
    for o in range(num_octaves(width, height)):
        if o:
            h, w = max(h // 2, 1), max(w // 2, 1)
        out.append((h, w))
    return out


def candidate_capacity(h: int, w: int, layers: int, num_features: int,
                       configured=None) -> int:
    """Raw extrema an octave keeps: the configured number, else
    max(512, min(h w layers / 384, 2 num_features)), at most h w layers."""
    cap = configured if configured is not None else \
        max(512, min(h * w * layers // 384, 2 * num_features))
    return int(min(cap, h * w * layers))


def tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32's 10-bit mantissa, to nearest even."""
    b = x.to(torch.float32).view(torch.int32)
    b = (b + 0xFFF + ((b >> 13) & 1)) & ~0x1FFF
    return b.view(torch.float32)


def _reflect101(n: int, pad: int, device) -> torch.Tensor:
    """Indices of -pad .. n-1+pad mirrored into 0 .. n-1 (dcb|abcd|cba)."""
    i = torch.arange(-pad, n + pad, device=device)
    if n == 1:
        return torch.zeros_like(i)
    period = 2 * (n - 1)
    i = torch.remainder(i, period)
    return torch.where(i >= n, period - i, i)


def _taps(sigma: float, truncate: float) -> np.ndarray:
    size = int(round(sigma * truncate + 1)) | 1
    x = np.arange(size, dtype=np.float64) - size // 2
    k = np.exp(-x * x / (2.0 * sigma * sigma))
    return k / k.sum()


class PlainResult(NamedTuple):
    """Keypoints (numpy fields x, y, octave, layer, angle, valid, size)
    and their descriptors [n, 128] uint8, n the count kept."""

    fields: dict
    descriptors: np.ndarray

    def padded(self, capacity: int, device):
        """(descriptors [capacity, 128] uint8, valid [capacity] bool) on
        ``device``, live rows first, as the detector hands them over."""
        n = len(self.descriptors)
        d = torch.zeros((capacity, 128), dtype=torch.uint8, device=device)
        d[:n] = torch.as_tensor(self.descriptors, device=device)
        return d, torch.arange(capacity, device=device) < n


class PlainSift:
    """image [H, W] grey values 0..255 -> ``PlainResult``."""

    def __init__(self, width: int, height: int, sift: dict, device,
                 precision: str = "float64"):
        if precision not in ("float64", "tf32"):
            raise ValueError(f"precision {precision!r}")
        s = dict(sift)
        self.w, self.h, self.device = int(width), int(height), device
        self.nf = int(s.get("num_features", 5000))
        self.L = int(s.get("num_octave_layers", 3))
        self.contrast = float(s.get("contrast_threshold", 0.04))
        self.edge = float(s.get("edge_threshold", 10.0))
        self.sigma = float(s.get("sigma", 1.6))
        self.truncate = float(s.get("kernel_truncate", 8.0))
        self.cand_conf = s.get("max_candidates_per_octave")
        for key, want in (("upscale", False), ("downsample", "nearest"),
                          ("orientation_source", "gaussian"),
                          ("subpixel", True),
                          ("interpolate_orientation", True),
                          ("descriptor_dtype", "uint8")):
            if s.get(key, want) != want:
                raise NotImplementedError(f"{key}={s[key]!r}")
        self.tf32 = precision == "tf32"
        self.dtype = torch.float32 if self.tf32 else torch.float64
        self.shapes = octave_shapes(self.w, self.h)
        k = 2.0 ** (1.0 / self.L)
        self.steps = [math.sqrt(max(self.sigma ** 2
                                    - 4 * INIT_SIGMA ** 2, 0.01))]
        self.steps += [self.sigma * k ** (i - 1) * math.sqrt(k * k - 1.0)
                       for i in range(1, self.L + 3)]
        self.taps = [_taps(s_, self.truncate) for s_ in self.steps]

    # -- pyramid ---------------------------------------------------------

    def _blur(self, img: torch.Tensor, i: int) -> torch.Tensor:
        """Separable blur of [H, W] by step ``i``'s taps, reflect-101."""
        taps = torch.as_tensor(self.taps[i], dtype=self.dtype,
                               device=img.device)
        if self.tf32:
            taps = tf32(taps)
        r = len(taps) // 2
        for dim in (0, 1):
            n = img.shape[dim]
            src = img.index_select(dim, _reflect101(n, r, img.device))
            if self.tf32:
                src = tf32(src)
            out = torch.zeros_like(img)
            for t in range(len(taps)):
                out += taps[t] * src.narrow(dim, t, n)
            img = out
        return img

    def pyramid(self, image: torch.Tensor):
        """Per octave: (Gaussian layers [L+3, h, w], differences
        [L+2, h, w])."""
        base = self._blur(image.to(self.dtype), 0)
        out = []
        for o, (h, w) in enumerate(self.shapes):
            if o:
                base = out[-1][0][self.L][::2, ::2][:h, :w].contiguous()
            layers = [base]
            for i in range(1, self.L + 3):
                layers.append(self._blur(layers[-1], i))
            g = torch.stack(layers)
            out.append((g, g[1:] - g[:-1]))
        return out

    # -- detection -------------------------------------------------------

    def _candidates(self, dog: torch.Tensor, h: int, w: int):
        """(layer, row, column) of the extrema of layers 1..L, scan
        order, up to the octave's capacity."""
        thr = math.floor(0.5 * self.contrast / self.L * 255.0)
        v = dog[1:-1]
        mx = F.max_pool3d(dog[None, None], 3, 1, 1)[0, 0, 1:-1]
        mn = -F.max_pool3d(-dog[None, None], 3, 1, 1)[0, 0, 1:-1]
        ext = (v.abs() > thr) & (((v > 0) & (v >= mx))
                                 | ((v < 0) & (v <= mn)))
        ys = torch.arange(h, device=dog.device)[:, None]
        xs = torch.arange(w, device=dog.device)[None, :]
        inside = ((ys >= BORDER) & (ys < h - BORDER)
                  & (xs >= BORDER) & (xs < w - BORDER))
        idx = torch.nonzero(ext & inside)
        cap = candidate_capacity(h, w, self.L, self.nf, self.cand_conf)
        idx = idx[:cap]
        return idx[:, 0] + 1, idx[:, 1], idx[:, 2]

    @staticmethod
    def _derivatives(dog, l, r, c):
        """Gradient [K, 3] and Hessian [K, 3, 3] (x, y, layer) of the
        differences at (l, r, c), on the 0..1 scale; and the value."""
        def at(dl, dr, dc):
            return dog[l + dl, r + dr, c + dc]
        s = 1.0 / 255.0
        v = at(0, 0, 0)
        dx = (at(0, 0, 1) - at(0, 0, -1)) * 0.5 * s
        dy = (at(0, 1, 0) - at(0, -1, 0)) * 0.5 * s
        ds = (at(1, 0, 0) - at(-1, 0, 0)) * 0.5 * s
        dxx = (at(0, 0, 1) + at(0, 0, -1) - 2 * v) * s
        dyy = (at(0, 1, 0) + at(0, -1, 0) - 2 * v) * s
        dss = (at(1, 0, 0) + at(-1, 0, 0) - 2 * v) * s
        dxy = (at(0, 1, 1) - at(0, 1, -1) - at(0, -1, 1)
               + at(0, -1, -1)) * 0.25 * s
        dxs = (at(1, 0, 1) - at(1, 0, -1) - at(-1, 0, 1)
               + at(-1, 0, -1)) * 0.25 * s
        dys = (at(1, 1, 0) - at(1, -1, 0) - at(-1, 1, 0)
               + at(-1, -1, 0)) * 0.25 * s
        grad = torch.stack([dx, dy, ds], -1)
        hess = torch.stack([torch.stack([dxx, dxy, dxs], -1),
                            torch.stack([dxy, dyy, dys], -1),
                            torch.stack([dxs, dys, dss], -1)], -2)
        return grad, hess, v

    def _refine(self, dog, l, r, c, h, w):
        """Newton steps from the candidates; returns (ok, l, r, c,
        offset [K, 3] (x, y, layer), |contrast|)."""
        alive = torch.ones_like(l, dtype=torch.bool)
        done = torch.zeros_like(alive)
        off = torch.zeros((len(l), 3), dtype=dog.dtype, device=dog.device)
        contrast = torch.zeros((len(l),), dtype=dog.dtype,
                               device=dog.device)
        edge_ok = torch.zeros_like(alive)
        for _ in range(MAX_STEPS):
            act = alive & ~done
            if not bool(act.any()):
                break
            ia = torch.nonzero(act)[:, 0]
            grad, hess, v = self._derivatives(dog, l[ia], r[ia], c[ia])
            x, info = torch.linalg.solve_ex(hess, grad[..., None])
            x = x[..., 0]
            ok = (info == 0) & torch.isfinite(x).all(-1)
            conv = ok & (x.abs() < 0.5).all(-1)
            # Converged: the offset, contrast and curvature at this point.
            ic = ia[conv]
            off[ic] = -x[conv]
            contrast[ic] = (v[conv] / 255.0
                            - 0.5 * (grad[conv] * x[conv]).sum(-1)).abs()
            tr = hess[conv, 0, 0] + hess[conv, 1, 1]
            det = hess[conv, 0, 0] * hess[conv, 1, 1] - hess[conv, 0, 1] ** 2
            edge_ok[ic] = (det > 0) & (tr * tr * self.edge
                                       < (self.edge + 1) ** 2 * det)
            done[ic] = True
            # Not converged: move to the nearest pixel and layer.
            step = ok & ~conv
            im = ia[step]
            mv = torch.round(x[step]).to(torch.int64)
            nl, nr, nc = l[im] - mv[:, 2], r[im] - mv[:, 1], c[im] - mv[:, 0]
            inb = ((nl >= 1) & (nl <= self.L) & (nr >= BORDER)
                   & (nr < h - BORDER) & (nc >= BORDER) & (nc < w - BORDER))
            l[im], r[im], c[im] = (torch.where(inb, nl, l[im]),
                                   torch.where(inb, nr, r[im]),
                                   torch.where(inb, nc, c[im]))
            alive[im[~inb]] = False
            alive[ia[~ok]] = False
        ok = (alive & done & edge_ok
              & (contrast * self.L >= self.contrast))
        return ok, l, r, c, off, contrast

    def keypoints(self, pyr):
        """Refined keypoints of every octave, scan order, at most
        ``num_features``: dict of tensors."""
        cands = []
        for o, (g, dog) in enumerate(pyr):
            h, w = self.shapes[o]
            l, r, c = self._candidates(dog, h, w)
            cands.append((o, l, r, c))
        kept, room = [], 2 * self.nf
        for o, l, r, c in cands:
            n = min(len(l), room)
            room -= n
            kept.append((o, l[:n], r[:n], c[:n]))
        parts = []
        for o, l, r, c in kept:
            h, w = self.shapes[o]
            ok, l, r, c, off, resp = self._refine(pyr[o][1], l.clone(),
                                                  r.clone(), c.clone(), h, w)
            i = torch.nonzero(ok)[:, 0]
            scale = float(2 ** o)
            xi = off[i, 2]
            parts.append({
                "x": (c[i] + off[i, 0]) * scale,
                "y": (r[i] + off[i, 1]) * scale,
                "octave": torch.full_like(l[i], o), "layer": l[i],
                "xi": xi, "response": resp[i],
                "size": self.sigma * torch.pow(
                    2.0, (l[i].to(xi.dtype) + xi) / self.L) * scale * 2.0})
        return {k: torch.cat([p[k] for p in parts])[:self.nf]
                for k in parts[0]}

    # -- orientation and descriptor ---------------------------------------

    def _window(self, pyr, kp, radius: int):
        """Offsets (i rows, j columns) [1, P], and for every keypoint the
        gradient (dx, dy) [K, P] on its Gaussian layer, with the mask of
        window pixels inside the image's interior."""
        dev = kp["x"].device
        ax = torch.arange(-radius, radius + 1, device=dev)
        i = ax[:, None].expand(-1, len(ax)).reshape(1, -1)
        j = ax[None, :].expand(len(ax), -1).reshape(1, -1)
        k = len(kp["x"])
        dx = torch.zeros((k, i.shape[1]), dtype=self.dtype, device=dev)
        dy = torch.zeros_like(dx)
        inner = torch.zeros_like(dx, dtype=torch.bool)
        for o, (g, _) in enumerate(pyr):
            sel = torch.nonzero(kp["octave"] == o)[:, 0]
            if not len(sel):
                continue
            h, w = self.shapes[o]
            inv = 1.0 / 2 ** o
            px = torch.round(kp["x"][sel] * inv).to(torch.int64)[:, None]
            py = torch.round(kp["y"][sel] * inv).to(torch.int64)[:, None]
            y, x = py + i, px + j
            ok = (y >= 1) & (y <= h - 2) & (x >= 1) & (x <= w - 2)
            yc, xc = y.clamp(1, max(h - 2, 1)), x.clamp(1, max(w - 2, 1))
            flat = g.reshape(-1)
            at0 = kp["layer"][sel].to(torch.int64)[:, None] * (h * w)

            def px_at(yy, xx):
                yy, xx = yy.clamp(0, h - 1), xx.clamp(0, w - 1)
                return flat[at0 + yy * w + xx]
            dx[sel] = px_at(yc, xc + 1) - px_at(yc, xc - 1)
            dy[sel] = px_at(yc - 1, xc) - px_at(yc + 1, xc)
            inner[sel] = ok
        return i.to(self.dtype), j.to(self.dtype), dx, dy, inner

    @staticmethod
    def _degrees(dy, dx):
        """Gradient direction in degrees, [0, 360)."""
        a = torch.rad2deg(torch.atan2(dy, dx))
        return torch.where(a < 0, a + 360.0, a)

    def orientations(self, pyr, kp):
        """The keypoints repeated once per dominant orientation, with
        ``angle``; at most ``num_features``."""
        scl = kp["size"] * 0.5 / torch.exp2(kp["octave"].to(self.dtype))
        rad = torch.round(ORI_RADIUS * scl)
        sig = ORI_SIG_FCTR * scl
        i, j, dx, dy, inner = self._window(pyr, kp, int(rad.max()))
        use = inner & (i.abs() <= rad[:, None]) & (j.abs() <= rad[:, None])
        wgt = torch.exp(-(i * i + j * j) / (2.0 * sig[:, None] ** 2))
        mag = torch.sqrt(dx * dx + dy * dy) * wgt * use
        b = torch.round(self._degrees(dy, dx) * (ORI_BINS / 360.0))
        b = torch.remainder(b, ORI_BINS).to(torch.int64)
        hist = torch.zeros((len(scl), ORI_BINS), dtype=self.dtype,
                           device=scl.device).scatter_add_(1, b, mag)
        sm = (6 * hist + 4 * (hist.roll(1, 1) + hist.roll(-1, 1))
              + hist.roll(2, 1) + hist.roll(-2, 1)) / 16.0
        left, right = sm.roll(1, 1), sm.roll(-1, 1)
        peak = ((sm > left) & (sm > right)
                & (sm >= ORI_PEAK_RATIO * sm.max(1, keepdim=True).values))
        kpi, bi = torch.nonzero(peak, as_tuple=True)   # keypoint-major
        kpi, bi = kpi[:self.nf], bi[:self.nf]
        lv, cv, rv = left[kpi, bi], sm[kpi, bi], right[kpi, bi]
        fb = bi.to(self.dtype) + 0.5 * (lv - rv) / (lv - 2 * cv + rv)
        fb = torch.remainder(fb, ORI_BINS)
        angle = 360.0 - fb * (360.0 / ORI_BINS)
        angle = torch.where((angle - 360.0).abs() < FLT_EPSILON,
                            torch.zeros_like(angle), angle)
        out = {k: v[kpi] for k, v in kp.items()}
        out["angle"] = angle
        return out

    def _descriptor_block(self, pyr, kp):
        d, nb = DESCR_WIDTH, DESCR_BINS
        scl = kp["size"] * 0.5 / torch.exp2(kp["octave"].to(self.dtype))
        ori = 360.0 - kp["angle"]
        ori = torch.where((ori - 360.0).abs() < FLT_EPSILON,
                          torch.zeros_like(ori), ori)
        hw = DESCR_SCL_FCTR * scl
        hs = torch.as_tensor(self.shapes, dtype=self.dtype,
                             device=scl.device)[kp["octave"]]
        rad = torch.minimum(torch.round(hw * math.sqrt(2.0) * (d + 1) * 0.5),
                            torch.sqrt((hs ** 2).sum(1)))
        i, j, dx, dy, inner = self._window(pyr, kp, int(rad.max()))
        a = torch.deg2rad(ori)[:, None]
        cos_t, sin_t = torch.cos(a) / hw[:, None], torch.sin(a) / hw[:, None]
        c_rot = j * cos_t - i * sin_t
        r_rot = j * sin_t + i * cos_t
        rbin = r_rot + d / 2 - 0.5
        cbin = c_rot + d / 2 - 0.5
        use = (inner & (i.abs() <= rad[:, None]) & (j.abs() <= rad[:, None])
               & (rbin > -1) & (rbin < d) & (cbin > -1) & (cbin < d))
        wgt = torch.exp(-(c_rot ** 2 + r_rot ** 2) / (d * d * 0.5))
        mag = torch.sqrt(dx * dx + dy * dy) * wgt * use
        obin = (self._degrees(dy, dx) - ori[:, None]) * (nb / 360.0)
        r0, c0, o0 = torch.floor(rbin), torch.floor(cbin), torch.floor(obin)
        fr, fc, fo = rbin - r0, cbin - c0, obin - o0
        o0 = torch.remainder(o0, nb)
        # (d + 2) x (d + 2) cells with a border, (nb + 2) bins; trilinear.
        hist = torch.zeros((len(scl), (d + 2) * (d + 2) * (nb + 2)),
                           dtype=self.dtype, device=scl.device)
        r0 = r0.clamp(-1, d).to(torch.int64) + 1
        c0 = c0.clamp(-1, d).to(torch.int64) + 1
        o0 = o0.to(torch.int64)
        for dr, wr in ((0, 1 - fr), (1, fr)):
            for dc, wc in ((0, 1 - fc), (1, fc)):
                for do, wo in ((0, 1 - fo), (1, fo)):
                    rr = (r0 + dr).clamp(max=d + 1)
                    cc = (c0 + dc).clamp(max=d + 1)
                    at = (rr * (d + 2) + cc) * (nb + 2) + o0 + do
                    hist.scatter_add_(1, at, mag * wr * wc * wo)
        hist = hist.view(-1, d + 2, d + 2, nb + 2)
        hist[..., 0] += hist[..., nb]
        hist[..., 1] += hist[..., nb + 1]
        v = hist[:, 1:d + 1, 1:d + 1, :nb].reshape(-1, d * d * nb)
        thr = torch.sqrt((v * v).sum(1, keepdim=True)) * DESCR_MAG_THR
        v = torch.minimum(v, thr)
        nrm = torch.sqrt((v * v).sum(1, keepdim=True))
        v = v * (INT_DESCR_FCTR / nrm.clamp(min=FLT_EPSILON))
        return torch.clamp(torch.round(v), 0, 255).to(torch.uint8)

    def descriptors(self, pyr, kp):
        n = len(kp["x"])
        return torch.cat([self._descriptor_block(
            pyr, {k: v[s:s + CHUNK] for k, v in kp.items()})
            for s in range(0, n, CHUNK)]) if n else \
            torch.zeros((0, 128), dtype=torch.uint8, device=self.device)

    @torch.no_grad()
    def __call__(self, image: torch.Tensor) -> PlainResult:
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            pyr = self.pyramid(image.to(self.device))
            kp = self.keypoints(pyr)
            if len(kp["x"]):
                kp = self.orientations(pyr, kp)
            else:
                kp["angle"] = kp["x"].clone()
            desc = self.descriptors(pyr, kp)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev
        fields = {k: kp[k].cpu().numpy() for k in
                  ("x", "y", "octave", "layer", "angle", "size")}
        fields["valid"] = np.ones(len(fields["x"]), bool)
        return PlainResult(fields, desc.cpu().numpy())
