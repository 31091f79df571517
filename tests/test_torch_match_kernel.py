"""The matcher's CUDA kernel (``csrc/match_u8.cu``) against its plain
version on the card, index for index: at the benchmark's call shapes, at
ragged and tiny shapes, on duplicated rows, extremes and empty masks.

Every test here needs a CUDA device and skips without one (a fixture
decides, never an import).  The file imports neither JAX nor the JAX
package; on a machine with the card, from the root of a checkout:

    python -m pytest tests/test_torch_match_kernel.py -q -o addopts="" \
        --noconftest -p no:cacheprovider
"""
import pytest
import torch

from sift_tpu_torch.kernels import match as KM
from sift_tpu_torch.perf import telemetry as T

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The inputs are made on the host: one intra-op thread keeps this
    file off the cores of the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU version")
    return torch.device("cuda")


def _sets(n_sets, rows, seed, dev, hi=120):
    """[n_sets, rows, 128] uint8 with structure: each set after the first
    repeats a noisy copy of half of the set before it, so queries have
    true matches, near ties and far rows."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randint(0, hi, (n_sets, rows, 128), generator=g)
    half = rows // 2
    for s in range(1, n_sets):
        noise = torch.randint(-4, 5, (half, 128), generator=g)
        x[s, :half] = (x[s - 1, half:2 * half] + noise).clamp(0, 255)
    return x.to(torch.uint8).to(dev)


def _prefix(n_sets, rows, live, dev):
    """Live-prefix masks as the detector and the benchmark make them."""
    return (torch.arange(rows, device=dev)[None, :]
            < torch.as_tensor(live, device=dev)[:, None]).expand(n_sets,
                                                                 rows)


def _held(q, t, qv=None, tv=None, ratio=0.8):
    """The kernel's indices equal the plain version's on the same CUDA
    tensors; returns them."""
    before = KM.launches["match_u8"]
    got = KM.match_u8_cuda(q, t, qv, tv, ratio)
    want = KM.match_u8_plain(q, t, qv, tv, ratio)
    torch.cuda.synchronize()
    assert KM.launches["match_u8"] == before + 1
    assert got.dtype == torch.int32 and got.shape == want.shape
    bad = int((got != want).sum())
    assert bad == 0, f"{bad} of {got.numel()} indices differ"
    return got


@pytest.mark.parametrize("cell", ["uhd_exhaustive", "wvga_exhaustive",
                                  "uhd_sequential"])
def test_kernel_equals_plain_at_the_cells_shapes(gpu, cell):
    """The benchmark's calls: ten [cap, 128] query sets against ten train
    sets (cap 10000 and 5000) with live prefixes, and one 10000-row frame
    against a ring of ten."""
    cap = 5000 if cell.startswith("wvga") else 10000
    live = [int(cap * f) for f in (0.45, 0.52, 0.61, 0.7, 0.38, 0.9, 0.17,
                                   0.73, 0.15, 1.0)]
    t = _sets(10, cap, 1, gpu)
    tv = _prefix(10, cap, live, gpu)
    if cell == "uhd_sequential":
        q, qv = t[3, :, :].clone(), tv[3].clone()
        q[: cap // 3] = t[0, cap // 2: cap // 2 + cap // 3]
    else:
        q = torch.roll(t, 1, 0)
        qv = torch.roll(tv, 1, 0)
    got = _held(q, t, qv, tv)
    assert int((got >= 0).sum()) > cap // 10


@pytest.mark.parametrize("nq", [1, 31, 64, 65, 200])
@pytest.mark.parametrize("ns", [1, 2, 63, 64, 127, 129, 300])
def test_kernel_equals_plain_at_ragged_shapes(gpu, nq, ns):
    """Q and S on and off the kernel's 64-row and 128-column tiles, S = 1
    included, with and without masks, broadcast and per-set queries."""
    t = _sets(3, ns, 2 + nq + ns, gpu)
    q = _sets(3, nq, 3 + nq + ns, gpu)
    q[:, : min(nq, ns) // 2] = t[:, : min(nq, ns) // 2]
    g = torch.Generator().manual_seed(nq * 1000 + ns)
    tv = (torch.rand(3, ns, generator=g) < 0.8).to(gpu)
    qv = (torch.rand(nq, generator=g) < 0.8).to(gpu)
    _held(q, t)
    _held(q, t, qv, tv)
    _held(q[0], t, qv, tv)
    _held(q[1], t[2], None, tv[2])


@pytest.mark.parametrize("ratio", [0.6, 0.8, 1.0, 1.5])
def test_kernel_equals_plain_on_duplicated_rows(gpu, ratio):
    """Exact and near duplicates: ties for the nearest row (no match up to
    a ratio of 1, the first column above it), duplicated queries, a row
    duplicated across a 128-column boundary."""
    t = _sets(2, 400, 4, gpu)
    t[:, 300] = t[:, 10]                   # across epochs
    t[:, 11] = t[:, 12]                    # across a quad's threads
    t[:, 17] = t[:, 16]                    # inside one thread's columns
    t[:, 26] = t[:, 2]                     # the same, 24 columns apart
    t[:, 200:264] = t[:, 100:164]          # a whole tile repeated
    q = t[:, :300].clone()
    q[:, 1::3, :2] += 1                    # near, not equal
    q[:, 50] = q[:, 51]
    got = _held(q, t, ratio=ratio)
    if ratio <= 1.0:
        for row in (2, 10, 12, 16):
            assert (got[:, row] == -1).all()


def test_kernel_equals_plain_on_extremes(gpu):
    """All-0 against all-255 rows (the 128 * 255^2 maximum), mixed
    extremes, and a set whose every row is 255."""
    g = torch.Generator().manual_seed(5)
    vals = torch.tensor([0, 1, 127, 128, 254, 255], dtype=torch.uint8)
    t = vals[torch.randint(0, 6, (4, 300, 128), generator=g)].to(gpu)
    q = vals[torch.randint(0, 6, (4, 150, 128), generator=g)].to(gpu)
    t[0] = 255
    q[0] = 0
    q[0, :5] = 255
    t[1, 7, :64] = 0
    q[1, :20] = 0
    q[2, :30] = t[2, 100:130]
    _held(q, t)
    _held(q, t, ratio=1.5)


def test_kernel_equals_plain_on_empty_masks(gpu):
    """Every train row masked, every query masked, exactly one train row
    live, and masks for some sets only."""
    t = _sets(3, 200, 6, gpu)
    q = _sets(3, 100, 7, gpu)
    none_t = torch.zeros(3, 200, dtype=torch.bool, device=gpu)
    none_q = torch.zeros(100, dtype=torch.bool, device=gpu)
    assert (_held(q, t, None, none_t) == -1).all()
    assert (_held(q, t, none_q, None) == -1).all()
    assert (_held(q, t, None, none_t, ratio=1.5) == 0).all()
    one = none_t.clone()
    one[:, 150] = True
    assert (_held(q, t, None, one) == 150).all()
    mixed = torch.ones_like(none_t)
    mixed[1] = False
    _held(q, t, None, mixed)


def test_matcher_takes_the_kernel_for_uint8_only(gpu):
    """``match_brute_force`` sends uint8 descriptors to the kernel (one
    launch, ``sift.match.fused`` and ``match.kernel_calls`` under the
    profiler) and float or int32 descriptors to the PyTorch code, all with
    the same indices."""
    from torch.profiler import ProfilerActivity, profile

    import sift_tpu_torch as stt
    t = _sets(2, 300, 8, gpu)
    q = t[0, :150].clone()
    before = KM.launches["match_u8"]
    u8 = stt.match_brute_force(q, t)
    assert KM.launches["match_u8"] == before + 1
    for dtype in (torch.float32, torch.int32):
        other = stt.match_brute_force(q.to(dtype), t.to(dtype))
        assert torch.equal(other, u8)
    assert KM.launches["match_u8"] == before + 1
    T.reset_program_counters()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = stt.match_brute_force(q, t)
    assert torch.equal(traced, u8)
    names = [e.name for e in prof.events() if e.name.startswith("sift.")]
    assert "sift.match.fused" in names
    assert "sift.match.gram" not in names and "sift.match.select" not in names
    counts = T.program_counters()
    T.reset_program_counters()
    assert counts["match.kernel_calls"] == 1
    assert counts["match.entries"] == 2 * 150 * 300
