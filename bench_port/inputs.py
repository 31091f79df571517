"""The benchmark's inputs, made on the device from the run's seed.

Two kinds of input set (the sequential mix renders views, the exhaustive
mix draws descriptor sets):

* ``rendered_views``: a textured plane (multi-scale value noise with a
  photo-like spectrum, as the port's ``perf/benchimg.bench_image`` makes
  it, here in torch on the device) seen by a camera moving once round a
  closed path: each view is shifted, turned and scaled a little from the
  one before, so neighbouring views overlap and the path wraps without a
  seam.  Returns ``[views, H, W]`` float32 grey values 0..255.
* ``landmark_sets``: descriptor sets as the detector hands them over
  (fixed capacity, live rows first, the rest zero and invalid), for a
  collection of images that see overlapping parts of one scene: the
  scene's landmarks lie on a ring, each image sees a run of them from its
  place on the ring on, and each of its live rows is either an
  observation of one of those landmarks (a SIFT-like uint8 descriptor with
  noise) or clutter seen once.  Images near each other on the ring share
  landmarks, so the ratio test finds real matches; the descriptors come
  from a space of few dimensions, as real SIFT descriptors do, so the
  ratio test also passes some rows of images that share nothing.

Everything is drawn from one ``torch.Generator`` on the device in a few
large calls; the same seed gives the same inputs.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def value_noise(h: int, w: int, scales, exponent: float,
                gen: torch.Generator, device) -> torch.Tensor:
    """[h, w] float32 0..255: bicubically upsampled normal noise at each
    scale, weighted by ``scale ** exponent``."""
    img = torch.zeros((h, w), dtype=torch.float32, device=device)
    for s in scales:
        n = torch.randn((1, 1, h // s + 2, w // s + 2), generator=gen,
                        device=device)
        img += F.interpolate(n, size=(h, w), mode="bicubic",
                             align_corners=False)[0, 0] * float(s) ** exponent
    img -= img.min()
    return img * (255.0 / max(float(img.max()), 1e-6))


def rendered_views(height: int, width: int, p: dict, gen, device
                   ) -> torch.Tensor:
    """``p``: views, path_radius (a share of the width), roll_deg, zoom,
    texture_scales, texture_exponent.  View v sits at angle 2*pi*v/views
    on a circle of ``path_radius * width`` pixels over the texture, turned
    by ``roll_deg * sin`` and scaled by ``1 + zoom * cos`` of that
    angle."""
    n, r = int(p["views"]), float(p["path_radius"]) * width
    roll, zoom = math.radians(float(p["roll_deg"])), float(p["zoom"])
    # A square texture that holds every view: the path's radius and the
    # zoomed frame's half diagonal (whatever the turn) from its centre.
    th = tw = 2 * int(math.ceil(r + 0.5 * math.hypot(width, height)
                                * (1.0 + zoom))) + 16
    tex = value_noise(th, tw, p["texture_scales"],
                      float(p["texture_exponent"]), gen, device)
    a = torch.arange(n, dtype=torch.float64, device=device) * (2 * math.pi
                                                                / n)
    cx = (tw - 1) / 2 + r * torch.cos(a)
    cy = (th - 1) / 2 + r * torch.sin(a)
    phi = roll * torch.sin(a)
    s = 1.0 + zoom * torch.cos(a)
    ys = torch.arange(height, dtype=torch.float64, device=device) \
        - (height - 1) / 2
    xs = torch.arange(width, dtype=torch.float64, device=device) \
        - (width - 1) / 2
    frames = torch.empty((n, height, width), dtype=torch.float32,
                         device=device)
    for v in range(n):
        c, sn = math.cos(float(phi[v])), math.sin(float(phi[v]))
        sv = float(s[v])
        px = cx[v] + sv * (c * xs[None, :] - sn * ys[:, None])
        py = cy[v] + sv * (sn * xs[None, :] + c * ys[:, None])
        grid = torch.stack([px / (tw - 1) * 2 - 1, py / (th - 1) * 2 - 1],
                           -1).to(torch.float32)
        frames[v] = F.grid_sample(tex[None, None], grid[None],
                                  mode="bilinear", align_corners=True)[0, 0]
    return frames


def _sift_like(n: int, basis: torch.Tensor, gen, device) -> torch.Tensor:
    """[n, 128] float32 unit-norm nonnegative vectors with a SIFT
    descriptor's shape: heavy-tailed entries from a space of
    ``basis.shape[0]`` dimensions, clipped at 0.2 of the norm and
    normalised again (OpenCV's descriptor normalisation)."""
    z = torch.randn((n, basis.shape[0]), generator=gen, device=device)
    v = (z @ basis).abs() ** 3
    v = v / v.norm(dim=1, keepdim=True).clamp(min=1e-12)
    v = v.clamp(max=0.2)
    return v / v.norm(dim=1, keepdim=True).clamp(min=1e-12)


def _quantize(v: torch.Tensor) -> torch.Tensor:
    """OpenCV's integer quantisation: 512 * value, rounded, saturated."""
    return torch.clamp(torch.round(v * 512.0), 0, 255).to(torch.uint8)


def landmark_sets(capacity: int, p: dict, gen, device):
    """``p``: num_sets, live_mean, live_spread, latent_dim, shared_share,
    pool_size, noise.  Returns (descriptors [num_sets, capacity, 128]
    uint8, valid [num_sets, capacity] bool).  Set i holds live rows drawn
    evenly from ``live_mean +- live_spread``; the first ``shared_share``
    of them observe the landmarks from its place on a ring of
    ``pool_size`` landmarks on (places ``pool_size / num_sets`` apart),
    one landmark a row, each with normal noise of ``noise`` on the 0..1
    scale before quantisation; the other live rows are clutter.
    Descriptors are drawn from a space of ``latent_dim`` dimensions."""
    n, cap = int(p["num_sets"]), int(capacity)
    pool_n = int(p["pool_size"])
    lo = int(p["live_mean"]) - int(p["live_spread"])
    hi = int(p["live_mean"]) + int(p["live_spread"])
    if not 0 < lo <= hi <= cap or pool_n < hi:
        raise ValueError(f"live rows {lo}..{hi} do not fit capacity {cap} "
                         f"or a ring of {pool_n} landmarks")
    basis = torch.randn((int(p["latent_dim"]), 128), generator=gen,
                        device=device)
    pool = _sift_like(pool_n, basis, gen, device)
    live = torch.randint(lo, hi + 1, (n,), generator=gen, device=device)
    seen = torch.round(live.to(torch.float32)
                       * float(p["shared_share"])).to(torch.int64)
    rows = torch.arange(cap, device=device)
    centre = (torch.arange(n, device=device) * pool_n) // n
    lm = (centre[:, None] + rows[None, :]) % pool_n
    noise = torch.randn((n, cap, 128), generator=gen, device=device) \
        * float(p["noise"])
    clutter = _sift_like(n * cap, basis, gen, device).view(n, cap, 128)
    vec = torch.where((rows[None, :] < seen[:, None])[..., None],
                      pool[lm] + noise, clutter)
    valid = rows[None, :] < live[:, None]
    desc = torch.where(valid[..., None], _quantize(vec),
                       torch.zeros((), dtype=torch.uint8, device=device))
    return desc, valid
