"""PyTorch port vs the JAX package: golden-checkpoint capture, per-stage
replay, the cv2 oracle and the CLI (perf/checkpoint.py, perf/replay.py,
perf/oracle.py, tools/perf.py).

The npz triple is framework-neutral, so the strongest gate there is without
a card: a golden captured by ``sift_tpu`` must pass all seven stages of the
port's ``Replayer`` — with the JAX package's own tolerances — and a golden
captured by the port must pass the JAX ``Replayer``.  The port runs on the
CPU (``device="cpu"``: plain versions of its kernels), the JAX package with
``gather_impl="auto"`` -> "xla" as its own tests do.
"""
import os

import numpy as np
import pytest
import torch

import sift_tpu
import sift_tpu_torch as stt
from conftest import synthetic_image, textured_image
from sift_tpu.perf import checkpoint as JC
from sift_tpu.perf import replay as JRP
from sift_tpu_torch.perf import checkpoint as TC
from sift_tpu_torch.perf import oracle as TOR
from sift_tpu_torch.perf import replay as TRP
from sift_tpu_torch.tools import perf as cli

# The golden of tests/test_perf_replay.py, and a textured frame with a few
# hundred octave-0 keypoints (the disc scene has a handful).
SCENES = {
    "discs_160x120": (lambda: synthetic_image(height=120, width=160, seed=2,
                                              n_blobs=20),
                      dict(width=160, height=120, num_features=500)),
    "texture_320x240": (lambda: textured_image(),
                        dict(width=320, height=240, num_features=600)),
}


def _capture_both(scene, tmp_path_factory):
    """One scene captured by both packages: (JAX golden, port golden)."""
    make, kw = SCENES[scene]
    img = make()
    jpath = str(tmp_path_factory.mktemp("jax_golden"))
    tpath = str(tmp_path_factory.mktemp("port_golden"))
    JC.capture_golden(sift_tpu.SiftConfig(**kw), img, jpath)
    TC.capture_golden(stt.SiftConfig(**kw), img, tpath, device="cpu")
    return jpath, tpath


@pytest.fixture(scope="module")
def goldens(tmp_path_factory):
    return _capture_both("discs_160x120", tmp_path_factory)


@pytest.fixture(scope="module")
def scene_goldens(request, goldens, tmp_path_factory):
    if request.param == "discs_160x120":
        return goldens
    return _capture_both(request.param, tmp_path_factory)


def _failures(results):
    return {k: v for k, v in results.items() if not v[0]}


@pytest.mark.parametrize("scene_goldens", list(SCENES), indirect=True)
def test_jax_golden_passes_port_replayer(scene_goldens):
    rep = TRP.Replayer(*TC.load_golden(scene_goldens[0]), device="cpu")
    results = rep.run_all()
    assert tuple(results) == TRP.Replayer.ALL == JRP.Replayer.ALL
    assert not _failures(results), results
    assert results["find_peaks"][1]["count"] > 0
    assert results["adjust_pts"][1]["count"] > 0


@pytest.mark.parametrize("scene_goldens", list(SCENES), indirect=True)
def test_port_golden_passes_jax_replayer(scene_goldens):
    results = JRP.Replayer(*JC.load_golden(scene_goldens[1])).run_all()
    assert not _failures(results), results


def test_port_golden_passes_port_replayer_and_has_the_jax_layout(goldens):
    """Same three files, same keys, dtypes and shapes as the JAX
    package's, so either package reads the other's checkpoint."""
    jpath, tpath = goldens
    results = TRP.Replayer(*TC.load_golden(tpath), device="cpu").run_all()
    assert not _failures(results), results
    assert (TC.PARAMS_FILE, TC.INPUT_FILE, TC.EXPECTED_FILE) \
        == (JC.PARAMS_FILE, JC.INPUT_FILE, JC.EXPECTED_FILE)
    for jd, td in zip(JC.load_golden(jpath), TC.load_golden(tpath)):
        assert set(jd) == set(td)
        for key in jd:
            assert jd[key].shape == td[key].shape, key
            assert jd[key].dtype == td[key].dtype, key
    assert TC.config_from_params(TC.load_golden(jpath)[0]) \
        == stt.SiftConfig(**{f: getattr(JC.config_from_params(
            JC.load_golden(tpath)[0]), f) for f in (
                "width", "height", "num_features", "sigma", "upscale")})


def test_replay_detects_corruption(goldens):
    """A corrupted golden output must fail verification."""
    params, inputs, expected = TC.load_golden(goldens[0])
    expected = dict(expected)
    expected["dog0"] = expected["dog0"] + 1.0
    rep = TRP.Replayer(params, inputs, expected, device="cpu")
    ok, info = rep.run_minus()
    assert not ok and info["max_err"] >= 1.0
    assert rep.run_filter()[0]               # the other stages still pass
    bad = dict(inputs)
    bad["kpt_angle"] = bad["kpt_angle"] + 45.0
    assert not TRP.Replayer(params, bad, TC.load_golden(goldens[0])[2],
                            device="cpu").run_descriptor()[0]


def test_cli_pass_fail_and_exit_codes(goldens, tmp_path, capsys):
    with pytest.raises(SystemExit) as e:
        cli.main([goldens[1], "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert e.value.code == 0
    assert len(lines) == 7 and all(ln.startswith("PASS") for ln in lines)
    assert [ln.split()[1] for ln in lines] == list(TRP.Replayer.ALL)

    params, inputs, expected = TC.load_golden(goldens[1])
    expected["dog0"] = expected["dog0"] + 1.0
    for name, d in ((TC.PARAMS_FILE, params), (TC.INPUT_FILE, inputs),
                    (TC.EXPECTED_FILE, expected)):
        np.savez_compressed(os.path.join(tmp_path, name), **d)
    with pytest.raises(SystemExit) as e:
        cli.main([str(tmp_path), "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert e.value.code == 1
    assert [ln.split()[0] for ln in lines].count("FAIL") == 1
    assert lines[2].startswith("FAIL  minus")

    with pytest.raises(SystemExit) as e:
        cli.main([str(tmp_path), "--device", "cpu", "--stage", "filter",
                  "--oracle"])
    out = capsys.readouterr().out
    assert e.value.code == 1 and "PASS  filter" in out \
        and "missing oracle.npz" in out


def test_entry_points_need_the_gpu_unless_told_and_switch_tf32_off(goldens):
    from sift_tpu_torch.pipeline.detector import full_precision_matmul
    torch.backends.cuda.matmul.allow_tf32 = True
    torch.backends.cudnn.allow_tf32 = True
    triple = TC.load_golden(goldens[1])
    TRP.Replayer(*triple, device="cpu")      # building a replayer ...
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    full_precision_matmul()
    assert not torch.backends.cuda.matmul.allow_tf32
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    with pytest.raises(RuntimeError):        # device=None means the GPU
        TRP.Replayer(*triple)
    with pytest.raises(RuntimeError):
        TC.capture_golden(stt.SiftConfig(width=64, height=48),
                          np.zeros((48, 64), np.float32), goldens[1])
    with pytest.raises(RuntimeError):
        cli.main([goldens[1]])


def test_oracle_verification(tmp_path):
    """A checkpoint with a recorded cv2.SIFT oracle verifies a FRESH run of
    the port's detector against the independent oracle (320x240, upscale),
    and a drifted oracle fails — tests/test_perf_replay.py's gate."""
    img = synthetic_image(height=240, width=320, seed=1, n_blobs=40)
    cfg = stt.SiftConfig(width=320, height=240, num_features=2000,
                         upscale=True)
    path = str(tmp_path)
    TC.capture_golden(cfg, img, path, device="cpu")
    assert not TOR.has_oracle(path)
    TOR.capture_oracle(cfg, img, path)
    assert TOR.has_oracle(path)
    checks = TOR.verify_oracle(path, device="cpu")
    assert checks["ok"], checks

    orc = dict(np.load(os.path.join(path, TOR.ORACLE_FILE)))
    orc["x"] = orc["x"] + 3.0
    np.savez_compressed(os.path.join(path, TOR.ORACLE_FILE), **orc)
    assert not TOR.verify_oracle(path, device="cpu")["ok"]
