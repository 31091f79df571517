"""The SIFT pipeline orchestrator — the public detect-and-compute API.

Counterpart of ``sift_tpu/pipeline/detector.py`` (``build_detect_fn`` and
``SiftDetector``).

Pipeline shape: the pyramid is a short chain of large matrix products;
detection runs over all octaves in ONE record-field kernel launch (each
octave at its own shape); candidates of all octaves take ONE Newton walk;
then keypoints of ALL octaves are compacted into ONE fixed-capacity set and
the orientation and descriptor kernels each run once per frame over a
row-stacked raw pyramid slab whose shifted copies one expansion kernel
writes (ops/flatpyr.py, kernels/expand.py).  That per-keypoint window
contract holds for patch radii up to 46 (the JAX detector's rule).  A
configuration with a larger radius (``sigma >= 1.96`` with the default
octave layers) takes the non-fused stages instead: dense gradient pyramids
at a uniform padded shape, one aligned window copy per keypoint
(kernels/window_gather.py), histograms by batched matrix products — with 4
shifted copies and 128-column windows while the radius is at most 47,
unshifted 256-column windows above.

Everything is static-shape and nothing on the path synchronises with the
host (no ``.item()``, ``.cpu()``, ``nonzero`` or boolean-mask indexing):
counts stay on the device, so the frame can later be captured in a CUDA
graph (not done yet).  Capacity tiers (``SiftDetector(tiers=...)``) are the
one exception, as in the JAX package: with tiers on, the detector reads the
frame's count back to pick the next frame's tier.

float32 matrix products run in full precision: building a detector calls
``full_precision_matmul`` (the JAX pyramid runs at ``Precision.HIGHEST``).
"""

from __future__ import annotations

from typing import Optional

import torch

from sift_tpu_torch.config import SiftConfig
from sift_tpu_torch.core.types import (Keypoints, SiftPlan, SiftResult,
                                       build_plan)
from sift_tpu_torch.kernels.fused_stages import (descriptor_hist,
                                                 orientation_hist)
from sift_tpu_torch.kernels.window_gather import window_rows
from sift_tpu_torch.ops import compact as C
from sift_tpu_torch.ops import descriptor as D
from sift_tpu_torch.ops import orientation as O
from sift_tpu_torch.ops.flatpyr import (dense_gradients_packed,
                                         dense_gradients_padded, pad_pyramid,
                                         shift_copies, stack_pyramid)
from sift_tpu_torch.ops.pyramid import (PlanOperators, dog_pyramid,
                                        gaussian_pyramid, plan_operators)
from sift_tpu_torch.ops.records import (WalkState, candidates_from_records,
                                        detect_records_pyramid,
                                        finalize_walk,
                                        resolve_kernel_impl,
                                        walk_records_positions)


def resolve_device(device) -> torch.device:
    """``None`` means the GPU: there is no silent fallback to the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "sift_tpu_torch runs on a CUDA device and none is "
                "available; pass device='cpu' explicitly to run the plain "
                "PyTorch versions on the CPU")
        return torch.device("cuda")
    return torch.device(device)


def full_precision_matmul() -> None:
    """Switch TF32 off for matrix products and cuDNN, process-wide.  Every
    entry point that runs the pyramid or a histogram contraction (a
    detector, a golden capture, a replayer) calls this where it is built."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# Largest patch radius the per-keypoint kernels' window contract holds
# (patch + gradient halo + the residual column offset within one aligned
# window), the 128-column shifted-copy contract of the non-fused stages,
# and their unshifted 256-column window (origin aligned down to 128).
FUSED_MAX_RADIUS = 46
FLAT_SHIFTED_MAX_RADIUS = 47
FLAT_MAX_RADIUS = 63


def slab_copies(plan: SiftPlan) -> int:
    """Shifted copies of the stacked slab, by the JAX detector's rule: 2
    when octave 0 spans at least 256 aligned columns, else 4."""
    wp0 = -(-max(plan.octaves[0].width, 128) // 128) * 128
    return 2 if wp0 >= 256 else 4


def build_detect_fn(plan: SiftPlan, quant_mode: str = "opencv",
                    kpt_cap: Optional[int] = None, device=None,
                    ops: Optional[PlanOperators] = None):
    """Returns the function image [H, W] f32 (on ``device``) -> SiftResult.

    ``kpt_cap`` bounds the INTERNAL keypoint capacity of both compactions
    and of the orientation and descriptor passes (a capacity tier;
    default num_features).  Outputs are always padded to num_features, so
    every tier gives the same shapes; a frame that fills the tier
    (``max(count, raw_count) == kpt_cap``) may have been truncated and
    should be run again at full capacity (``SiftDetector`` does).
    ``ops``: the plan's operators already on ``device`` (else moved)."""
    cfg = plan.config
    kcap = int(kpt_cap or cfg.num_features)
    if not 0 < kcap <= cfg.num_features:
        raise ValueError(f"kpt_cap {kcap} not in [1, num_features="
                         f"{cfg.num_features}]")
    dev = resolve_device(device)
    impl = resolve_kernel_impl(cfg.kernel_impl, dev)
    full_precision_matmul()

    rmax = max(D.max_descr_radius(cfg), O.max_ori_radius(cfg))
    ncop = slab_copies(plan)
    fused = rmax <= FUSED_MAX_RADIUS
    if rmax > FLAT_MAX_RADIUS:
        raise NotImplementedError(
            f"sigma={cfg.sigma}: patch radius {rmax} does not fit a "
            "256-column window")
    shift = shift_copies if rmax <= FLAT_SHIFTED_MAX_RADIUS \
        else (lambda p: p)
    if ops is None:
        ops = plan_operators(plan, dev)  # operators moved to the device once
    nb = O._NB
    bins = torch.arange(nb, dtype=torch.int32, device=dev)

    def detect(image: torch.Tensor) -> SiftResult:
        gauss = gaussian_pyramid(plan, image, ops)

        # Dense detection: ONE kernel launch for all octaves (DoG +
        # extrema + Newton records — the DoG volume is never
        # materialised), per-octave candidate compaction (octave-major
        # order), then ONE Newton walk over all octaves' candidates.
        recs = detect_records_pyramid(gauss, cfg, impl)
        cands = [candidates_from_records(recs[o], plan.octaves[o].cand_cap)
                 for o in range(cfg.num_octaves)]
        st, rflat = walk_records_positions(recs, cands, cfg)

        # Global compaction: ONE fixed-capacity keypoint set across all
        # octaves.  The walk's B/C planes (sub-pixel offsets, response) are
        # only gathered AFTER compaction — kcap rows, not candidate
        # capacity.  One packed row-gather instead of six.
        idx, val = C.stream_compact(st.ok, kcap)
        idx = idx.to(torch.int64)
        stm = torch.stack([st.l, st.r, st.c, st.ok.to(torch.int32),
                           st.octv], dim=1)
        stg = stm[idx]
        stc = WalkState(l=stg[:, 0], r=stg[:, 1], c=stg[:, 2],
                        ok=stg[:, 3].to(torch.bool), octv=stg[:, 4],
                        fi=st.fi[idx])
        ref, koct = finalize_walk(rflat, stc, val, cfg)
        kx, ky, klyr, kxi = ref.x, ref.y, ref.layer, ref.xi
        ksize, kresp = ref.size, ref.response

        n_kp = val.to(torch.int32).sum()
        if fused:
            # The per-keypoint kernels read RAW pixel windows off ONE
            # row-stacked slab of shifted copies (keypoint layers 1..L
            # only) and compute gradients + histograms on chip — no dense
            # gradient slabs.
            nl = cfg.num_octave_layers
            margin = window_rows(rmax)
            slab_g = stack_pyramid(gauss, extra_rows=margin, copies=ncop,
                                   layer_lo=1, layer_hi=nl + 1, impl=impl)
            if cfg.orientation_source == "gaussian":
                ori_slab = slab_g
            else:
                ori_slab = stack_pyramid(dog_pyramid(gauss),
                                         extra_rows=margin, copies=ncop,
                                         layer_lo=1, layer_hi=nl + 1,
                                         impl=impl)
            # Live counts let the kernels skip every block past the
            # frame's actual keypoint count (compactions are valid-first).
            ys0, xs0, par, rows, lanes = O.orientation_params(
                ori_slab, koct, kx, ky, klyr, ksize, val, cfg)
            hist = orientation_hist(ori_slab.values, ys0, xs0, par, rows,
                                    lanes, count=n_kp, impl=impl)
        else:
            # Dense gradients once per frame on the padded uniform stack.
            # The descriptor reads a PACKED (mag, ori) slab — one window
            # copy per keypoint; orientation keeps the full-precision pair
            # (its 1-degree parity gate is sensitive to quantisation).
            padded_gauss = pad_pyramid(gauss)
            gradf = shift(dense_gradients_packed(padded_gauss))
            o_mag, o_ori = dense_gradients_padded(
                padded_gauss if cfg.orientation_source == "gaussian"
                else pad_pyramid(dog_pyramid(gauss)))
            hist = O.orientation_histograms_flat(
                shift(o_mag), shift(o_ori), koct, kx, ky, klyr, ksize, val,
                cfg)
        angles, peaks = O.orientation_peaks(hist, val, cfg)

        # Expansion: up to 36 oriented copies per keypoint
        # (SiftOps.cu:338-373), flattened and compacted to num_features.
        eidx, evalid = C.stream_compact(peaks.reshape(-1), kcap)
        src = torch.div(eidx, nb, rounding_mode="floor").to(torch.int64)

        fm = torch.stack([kx, ky, kxi, ksize, kresp], dim=1)[src]
        im = torch.stack([klyr, koct], dim=1)[src]
        arow = angles[src]                                # [kcap, nb]
        bsel = (eidx % nb)[:, None] == bins
        kps = Keypoints(
            x=fm[:, 0], y=fm[:, 1],
            layer=im[:, 0],
            octave=im[:, 1],
            xi=fm[:, 2], size=fm[:, 3],
            response=fm[:, 4],
            angle=torch.where(bsel, arow, torch.zeros_like(arow)).sum(1),
            valid=evalid)

        n_desc = evalid.to(torch.int32).sum()
        if fused:
            ys0, xs0, par, rows, lanes = D.descriptor_params(
                slab_g, kps.octave, kps.x, kps.y, kps.layer, kps.size,
                kps.angle, kps.valid, cfg)
            dhist = descriptor_hist(slab_g.values, ys0, xs0, par, rows,
                                    lanes, count=n_desc, impl=impl)
            dhist = torch.where(evalid[:, None], dhist,
                                torch.zeros_like(dhist))
            desc, nrm2 = D.finalize_descriptor(dhist)
        else:
            desc, nrm2 = D.compute_descriptors_flat(
                gradf, kps.octave, kps.x, kps.y, kps.layer, kps.size,
                kps.angle, kps.valid, cfg)
        desc = D.quantize_descriptor(desc, nrm2, quant_mode)
        desc = torch.where(evalid[:, None], desc, torch.zeros_like(desc))
        if quant_mode == "opencv" and cfg.descriptor_dtype == "uint8":
            # Integer-quantised values fit one byte; the matcher's bf16
            # path matches bit-identically (config.descriptor_dtype).
            desc = desc.to(torch.uint8)

        if cfg.upscale:
            # OpenCV firstOctave = -1 final adjustment: halve coords/size,
            # octave index shifts down by one.
            kps = kps._replace(x=kps.x * 0.5, y=kps.y * 0.5,
                               size=kps.size * 0.5, octave=kps.octave - 1)
        if kcap < cfg.num_features:
            # Pad tiered outputs to the uniform num_features shape.
            pad = cfg.num_features - kcap
            padf = lambda a: torch.cat(
                [a, a.new_zeros((pad,) + tuple(a.shape[1:]))])
            kps = Keypoints(*[padf(f) for f in kps])
            desc = padf(desc)
        return SiftResult(keypoints=kps, descriptors=desc,
                          count=n_desc, raw_count=n_kp)

    return detect


class SiftDetector:
    """Convenience wrapper (≙ the reference ``Detector`` object).

    ``device=None`` means ``torch.device("cuda")`` and raises if CUDA is
    not available; pass ``device="cpu"`` to run the plain PyTorch versions
    on the CPU.  Keeps ``prev_descriptors``/``prev_result`` for sequential
    matching."""

    def __init__(self, config: SiftConfig, quant_mode: str = "opencv",
                 device=None, tiers: tuple = (),
                 plan: Optional[SiftPlan] = None):
        """``tiers``: optional internal keypoint-capacity tiers (e.g.
        (1024, 2048)); those below num_features are kept.  Each frame picks
        the smallest tier with 1.5x headroom over the previous frame's
        count (full capacity on the first frame) and runs again at full
        capacity when it fills the tier, so results equal the full
        detector's; outputs are padded to num_features.  With tiers on,
        every frame reads its count back to the host (one synchronisation;
        none without tiers).  ``plan``: a ready plan of this very
        ``config`` (e.g. core/convert.plan_from_numpy), else built here."""
        self.config = config
        self.device = resolve_device(device)
        if plan is None:
            plan = build_plan(config)
        elif plan.config != config:
            raise ValueError("plan was built for another config")
        self.plan = plan
        ops = plan_operators(plan, self.device)
        self._fn = build_detect_fn(self.plan, quant_mode,
                                   device=self.device, ops=ops)
        self.tiers = tuple(int(t) for t in sorted(tiers)
                           if int(t) < config.num_features)
        self._tier_fns = {t: build_detect_fn(self.plan, quant_mode, t,
                                             device=self.device, ops=ops)
                          for t in self.tiers}
        self._last_count: Optional[int] = None
        self.prev_result: Optional[SiftResult] = None  # frame t-1
        self.last_result: Optional[SiftResult] = None  # frame t

    def warm_up(self):
        """Run one frame at full capacity and one at every tier, so that
        nothing inside a tracking loop pays for first use (kernel build and
        load, cuBLAS handles, allocator growth).  Ends with a device
        synchronisation."""
        img = torch.zeros((self.config.height, self.config.width),
                          dtype=torch.float32, device=self.device)
        self._fn(img)
        for fn in self._tier_fns.values():
            fn(img)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return True

    def detect_and_compute(self, image) -> SiftResult:
        """image: [H, W] grayscale 0..255 (tensor or array-like); moved to
        the detector's device as float32."""
        image = torch.as_tensor(image).to(device=self.device,
                                          dtype=torch.float32)
        if tuple(image.shape) != (self.config.height, self.config.width):
            raise ValueError(
                f"image shape {tuple(image.shape)} != configured "
                f"{(self.config.height, self.config.width)}")
        tier = self._pick_tier()
        if tier is None:
            result = self._fn(image)
            if self.tiers:
                # The count steers the next frame's tier (the only host
                # synchronisation, and only with tiers on).
                self._last_count = int(result.count)
        else:
            result = self._tier_fns[tier](image)
            # Both compactions (keypoints, then oriented copies) run at the
            # tier, so a frame that fills either may have been truncated:
            # run it again at full capacity for the exact result.  One host
            # read for both counts.
            count, raw = torch.stack([result.count,
                                      result.raw_count]).tolist()
            if max(count, raw) >= tier:
                result = self._fn(image)
                count = int(result.count)
            self._last_count = count
        self.prev_result = self.last_result
        self.last_result = result
        return result

    def _pick_tier(self) -> Optional[int]:
        """Smallest tier with 1.5x headroom over the previous frame's
        count; None = full capacity (also for the first frame)."""
        if self._last_count is None or not self.tiers:
            return None
        need = max(64, int(self._last_count * 1.5))
        for t in self.tiers:
            if t >= need:
                return t
        return None

    @property
    def prev_descriptors(self):
        """Descriptors of the frame before the most recent one."""
        return None if self.prev_result is None \
            else self.prev_result.descriptors
