"""
The percentile kernel's "sliding" route (``csrc/percentile.cu``) modelled in
numpy, and its launch as ``kraken_tpu_torch/ops/binarize.py:plan`` mirrors
it.

The model follows the route step for step: a warp a tile of 33 - s lines
across (s, the window's short side, 1 or 2) and ``SLIDE_STEPS`` outputs
along them, the tile's strip read through numpy's reflect index (so any
pad, however much wider than the map, is exact), each lane's line of r
values kept as a sorted run (built by insertion; then, an output a step,
the leaving value found by binary search and the entering one shifted into
place; a NaN enters as +inf and is counted), and the two ranks of
``_ranks`` taken from the union of a lane's run and its right neighbour's
by the kernel's merge-path search (A first on ties), the two products and
their sum each rounded to fp32 once. It must give:

- the JAX package's ``kraken_tpu.ops.binarize._window_percentile`` within
  1e-6 (XLA:CPU contracts ``jnp.percentile``'s lerp into an FMA, which
  moves a result by up to 4.8e-7: ``tests/test_torch_binarize.py``) plus
  one ulp of the fp32 rank q = 0.8 (n - 1) times the map's range: XLA
  also multiplies by 0.01 where the source divides by 100, so its q, and
  the weights taken from it, may lie an ulp from the port's (3.1e-5 at
  n = 414, 1.9e-6 at n = 40), which moves a result by that much of the gap
  between the two order statistics;
- the port's plain version (``window_percentile_reference``) bit for bit,
  but on the signed-zero map, where a route may return either zero where
  -0.0 and +0.0 tie and the two are compared as values (-0.0 == +0.0);

at every case of ``chip_smoke.py``'s PERCENTILE_CASES and PERCENTILE_EDGES
that the sliding route takes, in both window shapes, and at a crop of the
fixture page's zoomed map. A window holding a NaN gives NaN and the error.

The plan: every pixel is taken by exactly one warp or block, shared memory
stays within an H100 block's, the page's windows take the sliding route,
and its edges (a range of 877 the longest a warp holds, 207 the longest
with four warps a block; windows with both sides over 2 count ranks) sit
where the source puts them, with the constants read back from the source
(the ``cuda`` test ``test_percentile_geometry_matches_its_plan`` holds the
source's own answer, ``percentile_geometry``, to the plan on the card).
"""
import bisect
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kraken_tpu.ops import binarize as jax_binarize
from kraken_tpu_torch.ops import binarize

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / 'kraken_tpu_torch' / 'csrc' / 'percentile.cu'
SMEM_PER_BLOCK = 232448   # 227 KB, the most an H100 block can have
TOL = 1e-6


def _smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke', ROOT / 'chip_smoke.py')
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


SMOKE = _smoke()


def reflect(i: np.ndarray, n: int) -> np.ndarray:
    """numpy's 'reflect' index into [0, n) for any index (the kernel's)."""
    if n == 1:
        return np.zeros_like(i)
    period = 2 * (n - 1)
    m = np.mod(i, period)
    return np.where(m < n, m, period - m)


def select(A: list, B: list, lo: int, hi: int) -> tuple[float, float]:
    """The lo-th and hi-th (hi <= lo + 1) of the union of two sorted runs of
    r values by the kernel's merge path: i of the lo smallest come from A,
    A first on ties."""
    r = len(A)
    a, b = max(0, lo - r), min(lo, r)
    while a < b:
        m = (a + b) >> 1
        if A[m] <= B[lo - m - 1]:
            a = m + 1
        else:
            b = m
    i, j = a, lo - a

    def from_a():
        return i < r and (j >= r or A[i] <= B[j])

    take_a = from_a()
    v_lo = A[i] if take_a else B[j]
    i, j = (i + 1, j) if take_a else (i, j + 1)
    v_hi = v_lo if hi == lo else (A[i] if from_a() else B[j])
    return v_lo, v_hi


def slide(run: list, gone: float, come: float) -> None:
    """One step of a lane's run: the first slot not below `gone` (which
    holds it) gives way to `come`, shifted into place as the kernel shifts
    it (past the smaller values to the right, or past the larger ones to
    the left)."""
    a = bisect.bisect_left(run, gone)
    del run[a]
    if come > gone:
        run.insert(bisect.bisect_left(run, come), come)
    else:
        run.insert(bisect.bisect_right(run, come), come)


def sliding_model(x: np.ndarray, perc: float, size: tuple[int, int]) -> tuple[np.ndarray, bool]:
    """The sliding route on one (H, W) map: the result, and whether a window
    held a NaN (the kernel's error bit)."""
    sh, sw = size
    vertical = sw <= 2
    r, s = (sh, sw) if vertical else (sw, sh)
    m = x if vertical else x.T                   # (along the runs, across them)
    n_long, n_short = m.shape
    outs, steps_max = 33 - s, binarize.SLIDE_STEPS
    before = (r - 1) // 2
    lo, hi, w_lo, w_hi = binarize._ranks(perc, r * s)
    w_lo, w_hi = np.float32(w_lo), np.float32(w_hi)
    out = np.full(m.shape, np.nan, np.float32)
    had_nan = False
    for p0 in range(0, n_long, steps_max):
        steps = min(steps_max, n_long - p0)
        strip = m[reflect(p0 - before + np.arange(steps + r - 1), n_long)]
        for q0 in range(0, n_short, outs):
            lines = strip[:, reflect(q0 + np.arange(32), n_short)].T   # (32, steps + r - 1)
            nans = np.isnan(lines[:, :r]).sum(axis=1)
            runs = []
            for lane in range(32):
                run = []
                for v in lines[lane, :r]:
                    bisect.insort_right(run, float('inf') if v != v else float(v))
                runs.append(run)
            for p in range(steps):
                if p > 0:
                    for lane in range(32):
                        gone, come = lines[lane, p - 1], lines[lane, p + r - 1]
                        nans[lane] += int(come != come) - int(gone != gone)
                        slide(runs[lane], float('inf') if gone != gone else float(gone),
                              float('inf') if come != come else float(come))
                for lane in range(min(outs, n_short - q0)):
                    if s == 1:
                        v_lo, v_hi = runs[lane][lo], runs[lane][hi]
                        window_nans = nans[lane]
                    else:
                        v_lo, v_hi = select(runs[lane], runs[lane + 1], lo, hi)
                        window_nans = nans[lane] + nans[lane + 1]
                    if window_nans:
                        had_nan = True
                        continue
                    out[p0 + p, q0 + lane] = (np.float32(np.float32(v_lo) * w_lo)
                                              + np.float32(np.float32(v_hi) * w_hi))
    return (out if vertical else out.T), had_nan


def model_maps(x: np.ndarray, perc: float, size) -> np.ndarray:
    results = [sliding_model(m, perc, size) for m in x]
    assert not any(nan for _, nan in results)
    return np.stack([res for res, _ in results])


def page_crop() -> np.ndarray:
    """A 96 x 80 crop of the fixture page's zoomed map (the map nlbin's
    first percentile takes), as chip_smoke zooms it."""
    page = SMOKE.zoomed_page(SMOKE.SEG_PAGE, torch.device('cpu')).numpy()
    return np.ascontiguousarray(page[:, 900:996, 600:680])


def smoke_cases() -> dict:
    """Every case of chip_smoke's percentile lists (its maps, made as it
    makes them), in both window shapes, by tag: (maps, window)."""
    cases = {}
    for shape, r in SMOKE.PERCENTILE_CASES:
        rng = np.random.RandomState(r * 1000 + shape[1])
        x = rng.rand(*shape).astype(np.float32)
        x.reshape(-1)[::3] = x.reshape(-1)[0]
        cases.update({f'{shape} {size}': (x, size) for size in ((r, 2), (2, r))})
    for i, (shape, r, values) in enumerate(SMOKE.PERCENTILE_EDGES):
        x = SMOKE.edge_map(shape, 5000 + i, values)
        cases.update({f'{shape} {size} {values}': (x, size) for size in ((r, 2), (2, r))})
    crop = page_crop()
    cases.update({f'page crop {size}': (crop, size) for size in ((20, 2), (2, 20))})
    return cases


CASES = smoke_cases()
SLIDING = sorted(tag for tag, (x, size) in CASES.items()
                 if binarize.plan(*x.shape, size)[0] == 'sliding')


def test_the_cases_cover_the_routes_and_their_edges():
    routes = {tag: binarize.plan(*x.shape, size)[0] for tag, (x, size) in CASES.items()}
    assert set(routes.values()) == {'sliding', 'staged', 'direct'}
    assert routes['(1, 9, 5) (877, 2) uniform'] == routes['(1, 9, 5) (2, 877) uniform'] == 'sliding'
    assert routes['(1, 9, 5) (878, 2) uniform'] == routes['(1, 9, 5) (2, 878) uniform'] == 'staged'
    assert binarize.plan(1, 40, 70, (207, 2))[2] == 4 and binarize.plan(1, 40, 70, (208, 2))[2] == 3
    # windows of 1 x 2, 2 x 1 (range 1), one row, one column, both orientations
    assert {'(1, 130, 70) (1, 2)', '(1, 130, 70) (2, 1)', '(1, 1, 50) (20, 2) uniform',
            '(1, 50, 1) (2, 20) uniform', 'page crop (2, 20)'} <= set(SLIDING)


@pytest.mark.parametrize('tag', SLIDING)
def test_sliding_model_equals_jax_and_the_plain_version(tag):
    x, size = CASES[tag]
    got = model_maps(x, 80, size)
    plain = binarize.window_percentile_reference(torch.from_numpy(x), 80, size).numpy()
    if tag.endswith('zeros'):
        assert np.array_equal(got, plain)   # values: -0.0 == +0.0
        assert (got == 0).any()             # the zeros do reach the result
    else:
        assert np.array_equal(got.view(np.int32), plain.view(np.int32))
    q = np.float32(0.8) * np.float32(size[0] * size[1] - 1)
    atol = TOL + np.spacing(q) * float(x.max() - x.min())
    for n in range(x.shape[0]):
        want = np.asarray(jax_binarize._window_percentile(jnp.asarray(x[n]), 80, size))
        np.testing.assert_allclose(got[n], want, rtol=0, atol=atol)


@pytest.mark.parametrize('perc', [0, 5, 50, 90, 100])
@pytest.mark.parametrize('size', [(7, 2), (2, 7), (4, 1), (1, 6), (2, 2)])
def test_sliding_model_at_other_percentiles(perc, size):
    """Ranks at the ends and in the middle, with lo == hi and lo + 1 == hi,
    windows of a single line and of two."""
    rng = np.random.RandomState(perc + 10 * size[0] + size[1])
    x = np.floor(rng.rand(1, 37, 41) * 8).astype(np.float32)
    got = model_maps(x, perc, size)
    plain = binarize.window_percentile_reference(torch.from_numpy(x), perc, size).numpy()
    assert np.array_equal(got.view(np.int32), plain.view(np.int32))


@pytest.mark.parametrize('size', [(5, 2), (2, 5), (3, 1)])
def test_a_nan_reaches_every_window_that_holds_it(size):
    rng = np.random.RandomState(3)
    x = rng.rand(11, 40).astype(np.float32)
    x[4, 33] = np.nan
    got, had_nan = sliding_model(x, 80, size)
    (top, bottom), (left, right) = binarize._pads(size)
    padded = x[reflect(np.arange(-top, 11 + bottom), 11)][:, reflect(np.arange(-left, 40 + right),
                                                                     40)]
    holds = np.zeros(x.shape, bool)
    for dy in range(size[0]):
        for dx in range(size[1]):
            holds |= np.isnan(padded[dy:dy + 11, dx:dx + 40])
    assert had_nan and np.array_equal(np.isnan(got), holds)
    plain = binarize.window_percentile_reference(torch.from_numpy(np.nan_to_num(x))[None], 80,
                                                 size)[0].numpy()
    assert np.array_equal(got[~holds], plain[~holds])


# ---------------------------------------------------------------- the plan

def pixels_taken(N: int, H: int, W: int, size) -> np.ndarray:
    """How many warps (sliding) or blocks take each pixel, as plan's
    docstring maps them."""
    route, (tw, th), tiles, _, blocks = binarize.plan(N, H, W, size)
    taken = np.zeros((N, H, W), np.int64)
    if route == 'sliding':
        vertical = size[1] <= 2
        groups, strips = (-(-W // tw), -(-H // th)) if vertical else (-(-H // th), -(-W // tw))
        units = N * groups * strips
        for u in range(blocks * tiles):
            if u >= units:
                continue
            n, strip, group = u // (strips * groups), u // groups % strips, u % groups
            gx, gy = (group, strip) if vertical else (strip, group)
            taken[n, gy * th:gy * th + th, gx * tw:gx * tw + tw] += 1
        assert blocks * tiles - units < tiles
    else:
        bx, by = -(-W // tw), -(-H // th)
        assert blocks == N * bx * by
        for b in range(blocks):
            n, rest = divmod(b, bx * by)
            y, x = divmod(rest, bx)
            taken[n, y * th:y * th + th, x * tw:x * tw + tw] += 1
    return taken


@pytest.mark.parametrize('N, H, W, size', [
    (1, 1982, 1371, (20, 2)), (1, 1982, 1371, (2, 20)), (3, 40, 64, (20, 2)), (2, 70, 45, (2, 20)),
    (1, 9, 5, (877, 2)), (1, 9, 5, (2, 877)), (3, 1, 30, (2, 7)), (2, 64, 1, (33, 2)),
    (1, 130, 70, (1, 2)), (1, 130, 70, (2, 1)), (2, 33, 95, (1, 1)), (3, 33, 33, (3, 33)),
    (1, 5, 7, (1800, 2)), (1, 5, 7, (2, 1800)), (2, 97, 65, (2, 2))])
def test_every_pixel_is_taken_once(N, H, W, size):
    assert (pixels_taken(N, H, W, size) == 1).all()


@pytest.mark.parametrize('size', [(1, 1), (20, 2), (2, 20), (207, 2), (208, 2), (2, 877),
                                  (877, 1), (878, 2), (3, 3), (2, 1800), (1800, 2), (7000, 2)])
def test_shared_memory_fits_a_block(size):
    route, (tw, th), tiles, smem, _ = binarize.plan(2, 300, 200, size)
    assert smem <= SMEM_PER_BLOCK
    if route == 'sliding':
        r = size[0] if size[1] <= 2 else size[1]
        assert 1 <= tiles <= binarize.SLIDE_WARPS
        assert smem == tiles * ((binarize.SLIDE_STEPS + r) * binarize.STRIDE + 32 * r) * 4
        assert tiles == binarize.SLIDE_WARPS or (tiles + 1) * smem // tiles > SMEM_PER_BLOCK
    elif route == 'staged':
        assert smem == (8 + size[0] - 1) * (32 + size[1] - 1) * 4


def test_the_page_windows_slide():
    """The fixture page's zoomed 1982 x 1371 map: both of nlbin's windows
    take the sliding route, four warps a block."""
    assert binarize.plan(1, 1982, 1371, (20, 2)) == ('sliding', (31, 32), 4, 4 * 9424, 698)
    assert binarize.plan(1, 1982, 1371, (2, 20)) == ('sliding', (32, 31), 4, 4 * 9424, 688)


def test_routes_change_where_the_source_puts_them():
    slides = [r for r in range(1, 1200) if binarize.plan(1, 50, 50, (r, 2))[0] == 'sliding']
    assert slides == list(range(1, binarize.SLIDE_MAX_RANGE + 1)) and slides[-1] == 877
    for sh, sw in ((3, 3), (20, 20), (3, 7)):
        assert binarize.plan(1, 50, 50, (sh, sw))[0] == 'staged'
    assert binarize.plan(1, 50, 50, (1700, 2))[0] == 'staged'
    assert binarize.plan(1, 50, 50, (1800, 2))[0] == 'direct'
    warps = [binarize.plan(1, 50, 50, (2, r))[2] for r in (1, 207, 208, 877)]
    assert warps == [4, 4, 3, 1]


def test_plan_constants_are_the_kernel_sources():
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf'constexpr int {name} = (\d+);', src).group(1))

    assert (const('TW'), const('TH')) == binarize.TILE
    assert const('kSlideSteps') == binarize.SLIDE_STEPS
    assert const('kSlideWarps') == binarize.SLIDE_WARPS
    assert const('kStride') == binarize.STRIDE
    assert 'enum Route { kDirect = 0, kStaged = 1, kSliding = 2 };' in src
    assert binarize.ROUTES == ('direct', 'staged', 'sliding')
    assert ('return ((size_t)(kSlideSteps + r) * kStride + (size_t)32 * r) * sizeof(float);'
            in src)
    assert 'const int outs = 33 - s;' in src and 'constexpr int kOuts = 33 - S;' in src


def test_the_cpu_counts_no_launch():
    x = torch.rand(1, 9, 8)
    before = (binarize.window_percentile.launches, dict(binarize.window_percentile.route_launches))
    binarize.window_percentile(x, 80, (20, 2))
    assert (binarize.window_percentile.launches,
            binarize.window_percentile.route_launches) == before
