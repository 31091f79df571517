"""PyTorch port: the detector's two example CLIs, ``tools/detect.py`` (with
its golden capture, replayed by ``tools/perf.py``) and
``tools/extract_and_match.py`` (capacity tiers, cv2 visualisations), run
in-process on small PGM frames with ``--device cpu``; the match counts
equal a library run of the same frames.
"""
import re
import sys

import numpy as np
import pytest
import torch

import sift_tpu_torch as stt
from conftest import synthetic_image
from sift_tpu_torch.io.image import load_grayscale
from sift_tpu_torch.perf.scenes import write_pgm
from sift_tpu_torch.tools import detect, extract_and_match
from sift_tpu_torch.tools import perf as perf_cli


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The frames here are small: one intra-op thread keeps this file off the cores of the
    suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """Three 160x120 PGM frames: the disc scene under small affine warps."""
    import cv2

    d = tmp_path_factory.mktemp("frames")
    base = synthetic_image(height=120, width=160, seed=3, n_blobs=25)
    for i in range(3):
        m = cv2.getRotationMatrix2D((80, 60), 2.0 * i, 1.0 + 0.01 * i)
        m[:, 2] += (1.5 * i, -i)
        img = cv2.warpAffine(base, m, (160, 120), flags=cv2.INTER_LINEAR,
                             borderMode=cv2.BORDER_REFLECT_101)
        write_pgm(str(d / f"frame_{i:04d}.pgm"), img)
    return d


def test_detect_cli_golden_replays_on_the_port(frames, tmp_path, capsys):
    pgm = str(frames / "frame_0000.pgm")
    golden, prof = tmp_path / "golden", tmp_path / "prof"
    detect.main([pgm, "--iters", "2", "--num-features", "500",
                 "--debug-path", str(golden), "--profile", str(prof),
                 "--device", "cpu"])
    out = capsys.readouterr().out
    assert "image 160x120" in out
    assert "golden checkpoint + cv2 oracle written" in out
    assert (prof / "trace.json").exists()
    n = int(re.search(r"keypoints: (\d+)", out).group(1))
    assert re.search(r"detect\+compute: median [0-9.]+ ms min [0-9.]+ ms "
                     r"over 2 iters", out)
    det = stt.SiftDetector(stt.SiftConfig(width=160, height=120,
                                          num_features=500), device="cpu")
    assert n == int(det.detect_and_compute(load_grayscale(pgm)).count) > 20
    with pytest.raises(SystemExit) as e:
        perf_cli.main([str(golden), "--device", "cpu"])
    out = capsys.readouterr().out
    assert e.value.code == 0, out
    assert out.count("PASS") == 7 and "FAIL" not in out


def test_extract_and_match_cli_tiers_and_visualisations(frames, tmp_path,
                                                        capsys):
    vis = tmp_path / "vis"
    # --num-features 1024: tiers 256 and 512 (frames 1-2 run at 256)
    extract_and_match.main([str(frames), "--num-features", "1024",
                            "--tiers", "--out-dir", str(vis),
                            "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 3
    got = [re.match(r"\[(\d)\] frame_\d+\.pgm: (\d+) kpts"
                    r"(?:, (\d+) matches to prev)? \([0-9.]+ ms\)", ln)
           for ln in lines]
    assert all(got), lines
    assert sorted(p.name for p in vis.iterdir()) == ["match_0001.png",
                                                     "match_0002.png"]
    # The library on the same frames: counts and matches equal.
    from sift_tpu_torch.io.image import load_image_directory
    _, imgs = load_image_directory(str(frames))
    det = stt.SiftDetector(stt.SiftConfig(width=160, height=120,
                                          num_features=1024), device="cpu")
    prev = None
    for g, img in zip(got, imgs):
        res = det.detect_and_compute(img)
        assert int(g.group(2)) == int(res.count)
        if prev is not None:
            m = stt.match_brute_force(res.descriptors, prev.descriptors,
                                      res.keypoints.valid,
                                      prev.keypoints.valid)
            assert int(g.group(3)) == int((m >= 0).sum()) > 0
        prev = res


def test_out_dir_raises_without_cv2(frames, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        extract_and_match.main([str(frames), "--out-dir",
                                str(tmp_path / "vis"), "--device", "cpu"])


def test_clis_need_the_gpu_unless_told(frames):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the CLIs run on it")
    with pytest.raises(RuntimeError, match="CUDA"):
        detect.main([str(frames / "frame_0000.pgm"), "--iters", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        extract_and_match.main([str(frames)])
