"""The JAX package's odometry and the port's on the SAME rendered frames:
the witness behind ``chip_smoke.py``'s ATE gates at the flagship size.

    JAX_PLATFORMS=cpu python tests/test_torch_vo_witness.py --scene loop \\
        --keypoints jax --geometry jax --seeds 0 1 2 3
    JAX_PLATFORMS=cpu python tests/test_torch_vo_witness.py --scene loop \\
        --keypoints torch --geometry torch --draws jax --seeds 0 1 2 3
    python tests/test_torch_vo_witness.py --scene textured --keypoints torch \\
        --geometry torch --device cuda --seeds 0

Renders a scene of ``sift_tpu_torch.perf.scenes.ODOMETRY_KW`` (752x480,
12 frames, ``num_features=2000``, the phase's settings) and detects its
frames once with the ``--keypoints`` package's ``SiftDetector``.  Then, once
per seed, runs the ``--geometry`` package's ``MonocularOdometry`` over
them, its detector replaced by one that hands out those results (the
detector is deterministic, so this equals running it in every run).  The
JAX odometry draws from ``jax.random.key(seed)`` and runs its geometry
under ``jax.jit``, as tests/test_torch_odometry.py does; the port draws from
``torch.Generator().manual_seed(seed)``, or with ``--draws jax`` takes the
sample indices the JAX odometry would draw for the same seed (the port's
``ransac_from_samples`` on them).  Prints one JSON line per run: modes,
matches, inliers, closures, the Sim(3)-aligned ATE and the seconds the
odometry took.  The JAX package runs on the CPU only.
"""
import argparse
import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np

_TESTS = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [os.path.dirname(_TESTS), _TESTS]

from sift_tpu_torch.perf import scenes  # noqa: E402

W, H = 752, 480


def _jax_cpu():
    import jax
    jax.config.update("jax_platforms", "cpu")
    return jax


def make_odometry(package, scene, width, height, seed, device=None):
    """``MonocularOdometry`` of either package with the scene's settings."""
    fx = 0.9 * width
    kw = dict(fx=fx, fy=fx, cx=width / 2, cy=height / 2, seed=seed,
              **scenes.ODOMETRY_KW[scene])
    if package == "jax":
        _jax_cpu()
        from sift_tpu.config import SiftConfig
        from sift_tpu.geometry.odometry import MonocularOdometry
        return MonocularOdometry(SiftConfig(
            width=width, height=height, num_features=scenes.VO_FEATURES),
            **kw)
    from sift_tpu_torch import SiftConfig
    from sift_tpu_torch.geometry.odometry import MonocularOdometry
    return MonocularOdometry(SiftConfig(
        width=width, height=height, num_features=scenes.VO_FEATURES),
        device=device, **kw)


def detect(package, frames, device=None):
    """Each frame's detector result as a dict of numpy fields."""
    h, w = frames[0].shape
    if package == "jax":
        _jax_cpu()
        from sift_tpu.config import SiftConfig
        from sift_tpu.pipeline.detector import SiftDetector
        det = SiftDetector(SiftConfig(width=w, height=h,
                                      num_features=scenes.VO_FEATURES))
        out = []
        for f in frames:
            r = det.detect_and_compute(f)
            d = {k: np.asarray(v) for k, v in r.keypoints._asdict().items()}
            d.update(descriptors=np.asarray(r.descriptors),
                     count=int(r.count), raw_count=int(r.raw_count))
            out.append(d)
        return out
    import torch

    from sift_tpu_torch import SiftConfig, SiftDetector
    from sift_tpu_torch.core.convert import result_to_numpy
    det = SiftDetector(SiftConfig(width=w, height=h,
                                  num_features=scenes.VO_FEATURES),
                       device=device)
    return [result_to_numpy(det.detect_and_compute(
        torch.as_tensor(f, device=det.device))) for f in frames]


class Replay:
    """A detector that hands out precomputed results, one per call."""

    def __init__(self, results):
        self.results = iter(results)

    def detect_and_compute(self, frame):
        return next(self.results)


def as_results(package, dets, device=None):
    """The numpy detector results as the ``package``'s ``SiftResult``."""
    if package == "jax":
        from test_torch_odometry import jax_result
        return [jax_result(d) for d in dets]
    from sift_tpu_torch.core.convert import sift_result_from_numpy
    return [sift_result_from_numpy(d, device) for d in dets]


@contextlib.contextmanager
def jax_draws(seed):
    """The port's odometry RANSAC on the sample indices that the JAX
    odometry draws for ``seed`` (its key stream, split once per call, and
    ``sift_tpu/geometry/twoview.py``'s categorical draw)."""
    jax = _jax_cpu()
    import jax.numpy as jnp
    import torch

    import sift_tpu_torch.geometry.odometry as todo
    from sift_tpu_torch.geometry.twoview import ransac_from_samples

    state = {"key": jax.random.key(seed)}

    def ransac(p1, p2, valid, generator=None, n_hypotheses=512,
               threshold=1e-5, sample_size=16, refit_iters=10):
        state["key"], k = jax.random.split(state["key"])
        logits = jnp.where(jnp.asarray(valid.cpu().numpy()), 0.0, -1e9)
        idx = jax.vmap(lambda kk: jax.random.categorical(
            kk, logits, shape=(sample_size,)))(
            jax.random.split(k, n_hypotheses))
        idx = torch.from_numpy(np.asarray(idx)).long().to(p1.device)
        return ransac_from_samples(p1, p2, valid, idx, threshold,
                                   refit_iters)

    saved = todo.ransac_essential
    todo.ransac_essential = ransac
    try:
        yield
    finally:
        todo.ransac_essential = saved


def run(geometry, scene, dets, gt, seed, draws="own", device=None,
        width=W, height=H):
    """One odometry run over the detector results; its JSON record."""
    from sift_tpu_torch.geometry.trajectory import ate_rmse

    odo = make_odometry(geometry, scene, width, height, seed, device)
    odo.detector = Replay(as_results(geometry, dets, odo.device
                                     if geometry == "torch" else None))
    if geometry == "jax":
        from test_torch_odometry import jax_geometry_jitted
        ctx = jax_geometry_jitted()
    elif draws == "jax":
        ctx = jax_draws(seed)
    else:
        ctx = contextlib.nullcontext()
    t0 = time.perf_counter()
    with ctx:
        for i in range(len(dets)):
            odo.process(i)
    res = odo.result
    return {"scene": scene, "geometry": geometry, "draws": draws,
            "seed": seed, "width": width, "height": height,
            "settings": scenes.ODOMETRY_KW[scene],
            "modes": res.modes, "n_matches": res.n_matches,
            "n_inliers": res.n_inliers,
            "closures": [list(map(int, c)) for c in odo.closures],
            "ate": ate_rmse(res.positions(), gt, with_scale=True),
            "seconds": time.perf_counter() - t0}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--scene", choices=sorted(scenes.ODOMETRY_KW),
                    required=True)
    ap.add_argument("--keypoints", choices=("jax", "torch"), required=True)
    ap.add_argument("--geometry", choices=("jax", "torch"), required=True)
    ap.add_argument("--draws", choices=("own", "jax"), default="own",
                    help="the port's RANSAC samples: its own generator, or "
                         "the JAX odometry's for the same seed")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0])
    ap.add_argument("--device", default=None,
                    help="the port's device (default CUDA)")
    args = ap.parse_args(argv)
    uses_jax = "jax" in (args.keypoints, args.geometry, args.draws)
    if uses_jax and args.device not in (None, "cpu"):
        ap.error("the JAX package runs on the CPU here")
    device = "cpu" if uses_jax else args.device
    card = None
    if device != "cpu":
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip()
    frames, gt = scenes.render_scene(args.scene, W, H)
    dets = detect(args.keypoints, frames, device)
    for seed in args.seeds:
        rec = run(args.geometry, args.scene, dets, gt, seed, args.draws,
                  device)
        print(json.dumps({**rec, "keypoints": args.keypoints,
                          "card": card}), flush=True)
    return 0


def test_witness_runs_both_packages_with_the_smoke_settings():
    """Each scene's settings build a MonocularOdometry in both packages,
    and the rendered scene is what the phases run: 12 finite frames of
    the asked size and a ground truth per frame."""
    for scene, kw in scenes.ODOMETRY_KW.items():
        frames, gt = scenes.render_scene(scene, 64, 48)
        assert len(frames) == scenes.VO_FRAMES == len(gt)
        assert all(f.shape == (48, 64) and np.isfinite(f).all()
                   for f in frames)
        for package in ("jax", "torch"):
            odo = make_odometry(package, scene, 64, 48, seed=3,
                                device="cpu")
            for key, val in kw.items():
                assert getattr(odo, key) == val, (package, key)


if __name__ == "__main__":
    sys.exit(main())
