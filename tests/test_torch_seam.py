"""
The port's device seam carver (``kraken_tpu_torch/ops/seam.py``) on the
CPU, where its wrappers run their plain versions, against the JAX package:

- the ragged carve's rows (each patch packed as it is, column-major, with
  its two pad rows) equal the JAX ``carve_seams_device`` on the padded
  batch and the native host DP, at chip_smoke.py's phase-26 seam cases and
  the fixture page's 92 patches, on the group and the block route's
  layouts; a batch of mixed heights whose sums overflow pins where the two
  part (a negative row counted from the patch's own end, not the common
  height);
- ``_carve_rows_device`` hands the polygonizer's patches to the ragged
  carve without forming a common-shape batch;
- malformed descriptors raise before any launch; the group route's plan
  mirrors the kernel's (``csrc/seam.cu``).

The kernel itself runs only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py --seam`` and ``--seg-routes``).
"""
import tests.test_torch_threads  # noqa: F401  (first: the thread share under xdist)
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
PAGE = ROOT / 'tests' / 'resources' / '170025120000003,0074.jpg'


def _smoke():
    """chip_smoke.py, whose seam cases these tests share."""
    spec = importlib.util.spec_from_file_location('chip_smoke', ROOT / 'chip_smoke.py')
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


SMOKE = _smoke()
CASES = SMOKE.seam_cases()


@pytest.fixture(scope='module')
def page_patches():
    """The fixture page's seam patches as the polygonizer hands them to the
    device carver (the port's segmentation with ``device_vectorize`` on
    the CPU)."""
    from PIL import Image
    from kraken_tpu_torch.configs import SegmentationInferenceConfig
    from kraken_tpu_torch.lib import polygonization
    from kraken_tpu_torch.tasks import SegmentationTaskModel
    task = SegmentationTaskModel.load_model()
    captured = []
    real = polygonization._carve_rows_device

    def spy(patches, device='cuda'):
        captured.append([np.array(p) for p in patches])
        return real(patches, device)
    polygonization._carve_rows_device = spy
    try:
        with Image.open(PAGE) as im:
            task.predict(im, SegmentationInferenceConfig(device='cpu', device_vectorize=True))
    finally:
        polygonization._carve_rows_device = real
    assert len(captured) == 1 and len(captured[0]) == 92
    return captured[0]


def _jax_rows(patches):
    """The JAX package's carve of the padded batch, each patch's rows with
    the pad offset removed."""
    from kraken_tpu.ops.seam import carve_seams_device
    batch, widths = SMOKE.seam_batch(patches)
    rows = carve_seams_device(batch, widths)
    return [rows[k, :widths[k]] - 1 for k in range(len(patches))]


def _check(patches, host_dp: bool):
    from kraken_tpu_torch.lib.polygonization import _carve_seam
    from kraken_tpu_torch.ops import seam
    rows = seam.carve_seams_ragged(patches, 'cpu')
    assert [len(r) for r in rows] == [p.shape[1] for p in patches]
    for warp_rows in (0, 2 * seam.GROUP_ROWS):  # every patch on the block route; the plan's
        packed = seam.pack_patches(patches, warp_rows=min(warp_rows, seam.GROUP_ROWS))
        np.testing.assert_array_equal(seam.seam_carve(packed, 'cpu'), np.concatenate(rows))
    if all(p.shape[1] == 1 for p in patches):  # the JAX package fails on such a batch
        with pytest.raises(IndexError):
            _jax_rows(patches)
    else:
        for got, want in zip(rows, _jax_rows(patches)):
            np.testing.assert_array_equal(got, want)
    if host_dp:
        for got, p in zip(rows, patches):
            np.testing.assert_array_equal(got, _carve_seam(p))


@pytest.mark.parametrize('case', range(len(CASES)), ids=[c[0] for c in CASES])
def test_ragged_rows_equal_jax_and_host_dp(case):
    tag, patches, host_dp = CASES[case]
    _check(patches, host_dp)


def test_fixture_page_rows_equal_jax_and_host_dp(page_patches):
    _check(page_patches, True)


def test_mixed_heights_whose_sums_overflow_part_as_decided():
    """Where every cost overflows, the backtrace walks off the patch and
    reads a negative row counted once from the end: of the common height in
    the padded batch (the JAX package), of the patch's own height in the
    ragged carve. A 6-row patch of near-3.4e38 energies beside a 12-row one
    parts there; the padded API keeps the JAX rows."""
    from kraken_tpu_torch.ops import seam
    rng = np.random.RandomState(1)
    for trial in range(3):
        rng.rand(3 + trial, 8)
        rng.rand(12, 8)
    patches = [rng.rand(6, 8).astype(np.float32) * np.float32(3.4e38),
               rng.rand(12, 8).astype(np.float32)]
    ragged = seam.carve_seams_ragged(patches, 'cpu')
    padded = _jax_rows(patches)
    np.testing.assert_array_equal(padded[0], [0, 0, -1, -2, -1, -2, -1, 0])
    np.testing.assert_array_equal(ragged[0], [-5, -4, -3, -2, -1, -2, -1, 0])
    np.testing.assert_array_equal(ragged[1], padded[1])
    batch, widths = SMOKE.seam_batch(patches)
    np.testing.assert_array_equal(seam.carve_seams_device(batch, widths, 'cpu')[0] - 1, padded[0])


def test_carve_rows_device_packs_no_common_shape(page_patches, monkeypatch):
    """The polygonizer's call packs each patch as it is: the buffer holds
    the descriptors and each patch's columns (its rows and two pad rows,
    rounded up to 4), far less than the common (N, H, W) batch, and one
    carve returns every row."""
    from kraken_tpu_torch.lib import polygonization
    from kraken_tpu_torch.ops import seam
    packs = []
    real = seam.pack_patches

    def spy(*args, **kwargs):
        packs.append(real(*args, **kwargs))
        return packs[-1]
    monkeypatch.setattr(seam, 'pack_patches', spy)
    rows = polygonization._carve_rows_device(page_patches, 'cpu')
    assert len(packs) == 1
    packed = packs[0]
    h = np.array([p.shape[0] + 2 for p in page_patches])
    w = np.array([p.shape[1] for p in page_patches])
    assert packed.buffer.numel() == seam.DESC_WORDS * packed.n_slots + int((w * ((h + 3) // 4 * 4)).sum())
    assert packed.buffer.numel() * 4 < 0.15 * len(h) * h.max() * w.max() * 4
    assert packed.total == sum(len(r) for r in rows) == int(w.sum())


@pytest.mark.parametrize('field, value', [('data', 3), ('height', 2), ('width', 1), ('out', 1),
                                          ('code', 8), ('index', 99), ('map', 2), ('group', 0x12)])
def test_malformed_descriptors_raise(field, value):
    """A descriptor that would read or write outside its buffers, repeat a
    patch or split a group raises ValueError before any launch (here: the
    plain version's check)."""
    from kraken_tpu_torch.ops import seam
    rng = np.random.RandomState(0)
    patches = [rng.rand(h, w).astype(np.float32) for h, w in ((300, 20), (30, 5), (2000, 3))]
    packed = seam.pack_patches(patches)
    seam.seam_carve(packed, 'cpu')
    words = ('data', 'height', 'width', 'out', 'code', 'index', 'map', 'group')
    desc = packed.descriptors()
    # a group route warp; for the code, the block route's patch (its
    # backtrack in global memory)
    slot = 0 if field == 'code' else packed.n_block + 1
    desc[slot, words.index(field)] += value
    with pytest.raises(ValueError, match='malformed|fit'):
        seam.seam_carve(packed, 'cpu')


def test_group_plan_mirrors_the_kernel():
    """Every height of the group route gets warps that all hold a row and a
    lane count the kernel reads back from (height, warps); the constants
    the plan uses are the kernel source's."""
    from kraken_tpu_torch.ops import seam
    for h in range(3, seam.GROUP_ROWS + 1):
        g, r = seam.group_plan(h)
        assert 1 <= g <= seam.WARPS and r % 2 == 1 and r <= 15
        assert (g - 1) * 32 * r < h <= g * 32 * r and seam.lane_rows(h, g) == r
    assert seam.group_plan(seam.GROUP_ROWS + 1) is None
    src = (ROOT / 'kraken_tpu_torch' / 'csrc' / 'seam.cu').read_text()
    consts = dict(re.findall(r'constexpr int (k\w+) = (\d+);', src))
    assert (int(consts['kWarps']), int(consts['kStages']), int(consts['kGroupRows']),
            int(consts['kRegionHead']), int(consts['kRing'])) == \
        (seam.WARPS, seam.STAGES, seam.GROUP_ROWS, seam.REGION_HEAD, seam.RING)
    assert sorted(int(r) for r in re.findall(r'case (\d+): SEAM_GROUP', src)) == [1, 3, 5, 7, 9,
                                                                                11, 13]
