"""The benchmark's copies of the roofline counts equal the port's proof
script's (``chip_smoke.py``) on small tensors."""

import importlib.util

import pytest
import torch

from bench_port import rooflines as R

from conftest import ROOT


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _par(k, seed=3):
    g = torch.Generator().manual_seed(seed)
    p = torch.zeros((k, 13))
    p[:, 0] = -torch.randint(8, 30, (k,), generator=g).float()
    p[:, 1] = -torch.randint(8, 60, (k,), generator=g).float()
    p[:, 2] = -torch.rand(k, generator=g) * 40
    p[:, 3] = torch.rand(k, generator=g) * 40
    p[:, 4] = -torch.rand(k, generator=g) * 40
    p[:, 5] = torch.rand(k, generator=g) * 40
    p[:, 7] = torch.rand(k, generator=g) * 30 + 2
    p[:, 8] = (torch.rand(k, generator=g) > 0.2).float()
    ang = torch.rand(k, generator=g) * 6.28
    p[:, 9], p[:, 10] = torch.cos(ang) * 0.3, torch.sin(ang) * 0.3
    return p


def test_constants_and_peaks(smoke):
    assert R.PEAK_BYTES_PER_S == smoke.PEAK_BYTES_PER_S
    assert R.PEAK_F32_FLOPS == smoke.PEAK_F32_FLOPS
    assert R.DETECT_OPS_PER_RECORD == smoke.DETECT_OPS_PER_RECORD
    assert R.DESC_OPS_PER_MASKED_PIXEL == smoke.DESC_OPS_PER_MASKED_PIXEL
    assert R.DESC_OPS_PER_GRID_PIXEL == smoke.DESC_OPS_PER_GRID_PIXEL


@pytest.mark.parametrize("k,rows,lanes,count", [(40, 48, 128, 33),
                                                (17, 64, 128, 17),
                                                (25, 32, 128, 0)])
def test_window_counts_equal_the_proof_scripts(smoke, k, rows, lanes,
                                               count):
    par = _par(k)
    a = R.window_work(par, rows, lanes, count)
    b = smoke.window_work(par, rows, lanes, count)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    assert R.grid_pixels(par, rows, lanes, count, chunk=7) \
        == smoke.grid_pixels(par, rows, lanes, count, chunk=7)
    values = torch.zeros((64, 256))
    for nbins in (36, 128):
        assert R.stage_bytes(values.numel(), par, a[0], a[1], count,
                             nbins) \
            == smoke.stage_bytes(values, par, b[0], b[1], count, nbins)


def test_record_field_and_copy_bytes_follow_the_proof_script():
    # chip_smoke.check_detect: (nl + 3 (nl - 3)) * pixels * 4 bytes and
    # 250 (nl - 3) pixels operations; check_expand: (1 + copies) * base.
    shapes, nl = [(120, 160), (60, 80), (30, 40)], 6
    pix = sum(h * w for h, w in shapes)
    assert R.detect_records_bytes(shapes, nl) == (nl + 3 * (nl - 3)) \
        * pix * 4
    assert R.detect_records_ops(shapes, nl) == 250 * (nl - 3) * pix
    assert R.expand_bytes(1000, 2) == 3 * 1000 * 4


def test_match_work_counts_each_set_once():
    b, ops = R.match_work(10, 100, 200, query_sets=1)
    assert ops == 10 * 2 * 100 * 200 * 128
    assert b == (100 + 10 * 200) * 129 + 10 * 100 * 4
    b2, _ = R.match_work(10, 100, 200)
    assert b2 == (10 * 100 + 10 * 200) * 129 + 10 * 100 * 4
