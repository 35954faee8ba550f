"""
The 20×20 max filter (``csrc/segmask.cu`` ``maxpool20_kernel``) modelled in
numpy, step for step.

The model follows the kernel's launch (a block a tile of 141 output columns
and 20 output rows, grid: column tiles x strips x maps) and each block's
work: a thread a column of the tile's 160 input columns (the 141 and the
window's 19 of halo), reflected only in a tile within 10 pixels of an edge
(the strip's 39 row indices as one table, each thread's column once);
the vertical van Herk / Gil-Werman pass over its 39 rows (the suffix maxima
of the first 20, then the running prefix of the next 19, an output row the
max of one of each); the horizontal pass over the 20 staged rows, a thread
a segment of 20 columns of a row (its prefix and suffix maxima); then a
thread an output column, each output the max of one suffix and one prefix.
Every max is the kernel's ``nan_max(m, v)``: v where ``v > m`` or v is NaN,
else m, in the kernel's operand order.

It must give:

- the plain version (``maxpool20_reference``) and the JAX package's
  ``_maxpool20`` bit for bit (a NaN where a window holds one: as values
  against JAX, whose NaN may carry another payload), but on the signed-zero
  map, where each order of the max (the kernel's, the plain version's,
  XLA's) keeps another zero of some -0.0 and +0.0 ties and the results are
  compared as values (-0.0 == +0.0; ROADMAP §3, by decision);
- every output pixel taken by exactly one thread, the reflection computed
  only where a tile's input leaves the map, no bank conflict in the
  horizontal pass, the shared memory ptxas reports;

at every map of ``chip_smoke.py``'s SEGMASK_SMALL_MAPS, sides of 19-21 and
39-41 and of the tile's 141 columns ±1, maps under the 10-pixel pad, the
fixture page's shape, NaN and -inf maps; with the constants read back from
the source.
"""
import tests.test_torch_threads  # noqa: F401  (first: the thread share under xdist)
import importlib.util
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kraken_tpu.inference.segmentation import _maxpool20
from kraken_tpu_torch.ops import segmask

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / 'kraken_tpu_torch' / 'csrc' / 'segmask.cu'

WIN = 20              # window side and segment length
BEFORE = 10           # scipy's origin-0 anchor
THREADS = 160         # a block: the tile's input columns
OUT = THREADS - WIN + 1   # output columns of a tile (141)
STRIP = WIN           # output rows of a tile
SEGS = THREADS // WIN     # segments of a staged row
PITCH = THREADS + 1   # staged row pitch
ROWS = STRIP + WIN - 1    # input rows of a tile (39)


def _smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke', ROOT / 'chip_smoke.py')
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


SMOKE = _smoke()


def reflect(i: np.ndarray, n: int) -> np.ndarray:
    """np.pad(mode='symmetric') index: periodic over 2n, the second half
    mirrored (the kernel's ``reflect``)."""
    m = np.mod(i, 2 * n)
    return np.where(m < n, m, 2 * n - 1 - m)


def nan_max(m: np.ndarray, v: np.ndarray) -> np.ndarray:
    """The kernel's ``nan_max(m, v)``: v where v > m or v is NaN, else m."""
    with np.errstate(invalid='ignore'):
        return np.where((v > m) | np.isnan(v), v, m)


def tile(src: np.ndarray, x0: int, y0: int) -> tuple[np.ndarray, bool, bool]:
    """One block on a (H, W) map: its (20, 141) outputs and whether it
    reflected its columns and its rows."""
    H, W = src.shape
    y_top, x_left = y0 - BEFORE, x0 - BEFORE
    gx = x_left + np.arange(THREADS)
    edge_cols = x_left < 0 or x_left + THREADS > W
    edge_rows = y_top < 0 or y_top + ROWS > H
    col = reflect(gx, W) if edge_cols else gx
    rows = y_top + np.arange(ROWS)
    if edge_rows:
        rows = reflect(rows, H)
    a = src[rows][:, col]                               # (39, 160): a thread a column
    # vertical pass: the suffix maxima of rows 0-19, the running prefix of 20-38
    h = a[:WIN].copy()
    for k in range(WIN - 2, -1, -1):
        h[k] = nan_max(h[k + 1], h[k])
    s_v = np.empty((STRIP, THREADS), np.float32)
    s_v[0] = h[0]
    g = a[WIN]
    for k in range(1, WIN):
        s_v[k] = nan_max(h[k], g)
        if k < WIN - 1:
            g = nan_max(g, a[WIN + k])
    # horizontal pass: a thread a (row, segment)
    seg = s_v.reshape(STRIP, SEGS, WIN)
    pre, suf = np.empty_like(seg), seg.copy()
    m = seg[:, :, 0]
    pre[:, :, 0] = m
    for j in range(1, WIN):
        m = nan_max(m, seg[:, :, j])
        pre[:, :, j] = m
    m = seg[:, :, WIN - 1]
    for j in range(WIN - 2, -1, -1):
        m = nan_max(m, seg[:, :, j])
        suf[:, :, j] = m
    s_h, s_g = suf.reshape(STRIP, THREADS), pre.reshape(STRIP, THREADS)
    return nan_max(s_h[:, :OUT], s_g[:, WIN - 1:WIN - 1 + OUT]), edge_cols, edge_rows


def model(x: np.ndarray) -> tuple[np.ndarray, np.ndarray, int]:
    """The kernel's (M, H, W) output, how many threads wrote each pixel and
    how many tiles reflected an index."""
    M, H, W = x.shape
    out = np.full(x.shape, np.nan, np.float32)
    writes = np.zeros(x.shape, np.int64)
    reflected = 0
    for z in range(M):
        for by in range(-(-H // STRIP)):
            for bx in range(-(-W // OUT)):
                x0, y0 = bx * OUT, by * STRIP
                res, edge_cols, edge_rows = tile(x[z], x0, y0)
                reflected += edge_cols or edge_rows
                # an interior tile's indices lie in the map: it reads straight
                if not edge_cols:
                    assert x0 - BEFORE >= 0 and x0 - BEFORE + THREADS <= W
                if not edge_rows:
                    assert y0 - BEFORE >= 0 and y0 - BEFORE + ROWS <= H
                # a thread a column u < 141 inside the map, its rows inside it
                for u in range(min(OUT, W - x0)):
                    for r in range(min(STRIP, H - y0)):
                        out[z, y0 + r, x0 + u] = res[r, u]
                        writes[z, y0 + r, x0 + u] += 1
    return out, writes, reflected


def _maps() -> dict:
    rng = np.random.default_rng(0)

    def heat(shape):
        return (1 / (1 + np.exp(-4 * rng.standard_normal(shape)))).astype(np.float32)

    cases = {f'small {s}': heat(s) for s in SMOKE.SEGMASK_SMALL_MAPS}
    for h, w in ((19, 19), (20, 20), (21, 21), (39, 39), (40, 40), (41, 41), (19, 41), (41, 20),
                 (21, 140), (20, 141), (19, 142), (3, 281), (5, 282), (2, 283)):
        cases[f'{h}x{w}'] = heat((1, h, w))
    for h, w in ((3, 9), (9, 3), (2, 2), (7, 1)):
        cases[f'under the pad {h}x{w}'] = heat((2, h, w))
    cases['page (2, 512, 354)'] = heat((2, 512, 354))
    nan = heat((2, 45, 150))
    nan[0, 3, 7] = nan[1, 44, 149] = nan[1, 20, 70] = np.nan
    cases['nan'] = nan
    ninf = heat((1, 50, 160))
    ninf[0, ::3] = -np.inf
    ninf[0, 10:40, 30:90] = -np.inf
    cases['-inf'] = ninf
    zeros = np.where(rng.random((2, 60, 170)) < 0.5, np.float32(0.0), np.float32(-0.0))
    zeros[0, 30:35, 40:45] = 0.25
    cases['signed zeros'] = zeros.astype(np.float32)
    return cases


MAPS = _maps()


def test_the_cases_cover_the_edges():
    sides = {s for x in MAPS.values() for s in x.shape[1:]}
    assert {19, 20, 21, 39, 40, 41, OUT - 1, OUT, OUT + 1} <= sides
    assert min(sides) < BEFORE and all(s in MAPS for s in (f'small {s}' for s in
                                                         SMOKE.SEGMASK_SMALL_MAPS))


@pytest.mark.parametrize('tag', list(MAPS))
def test_model_equals_the_plain_version_and_jax(tag):
    x = MAPS[tag]
    got, writes, reflected = model(x)
    assert (writes == 1).all()
    assert reflected >= 1
    plain = segmask.maxpool20_reference(torch.from_numpy(x)).numpy()
    theirs = np.asarray(_maxpool20(jnp.asarray(x)))
    if tag == 'signed zeros':
        assert np.array_equal(got, plain) and np.array_equal(got, theirs)   # -0.0 == +0.0
        assert (got == 0).any()
        # the three orders of the max keep other zeros on ties: the decision
        bits = [a.view(np.int32) for a in (got, plain, theirs)]
        assert all((a != b).any() for a, b in ((bits[0], bits[1]), (bits[0], bits[2]),
                                                (bits[1], bits[2])))
    else:
        assert np.array_equal(got.view(np.int32), plain.view(np.int32))
        assert np.array_equal(got, theirs, equal_nan=True)
    if tag == 'nan':
        assert np.isnan(got[0, :14, :18]).all() and not np.isnan(got[0, 14:]).any()


def test_interior_tiles_reflect_nothing():
    """The page's shape: of its 3 x 26 tiles a map, only those within 10
    pixels of an edge (the first and last column tile, the first and last
    strip) reflect."""
    x = MAPS['page (2, 512, 354)'][:1]
    _, _, reflected = model(x)
    assert reflected == 3 * 26 - 1 * 24


def test_the_horizontal_pass_has_no_bank_conflict():
    u = np.arange(THREADS)
    r, c0 = u % STRIP, (u // STRIP) * WIN
    for warp in range(THREADS // 32):
        lanes = slice(32 * warp, 32 * warp + 32)
        for j in range(WIN):
            banks = (r[lanes] * PITCH + c0[lanes] + j) % 32
            assert len(set(banks.tolist())) == 32


def test_the_launch_and_shared_memory():
    """The grid of the page's and the full-size spec's maps, and the
    shared memory that ptxas reports (25,916 bytes: two 20 x 161 fp32
    stages and the 39-row table)."""
    assert (-(-354 // OUT), -(-512 // STRIP), 2) == (3, 26, 2)
    assert (-(-1245 // OUT), -(-1800 // STRIP), 2) == (9, 90, 2)
    assert 2 * STRIP * PITCH * 4 + ROWS * 4 == 25916


def test_plan_constants_are_the_kernel_sources():
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf'constexpr int {name} = (\d+);', src).group(1))

    assert (const('kWin'), const('kBefore'), const('kPoolThreads')) == (WIN, BEFORE, THREADS)
    assert (segmask.WINDOW, segmask.BEFORE) == (WIN, BEFORE)
    assert 'constexpr int kPoolOut = kPoolThreads - kWin + 1;' in src
    assert 'constexpr int kStrip = kWin;' in src
    assert 'constexpr int kSegs = kPoolThreads / kWin;' in src
    assert 'constexpr int kPitch = kPoolThreads + 1;' in src
    assert 'constexpr int kStripRows = kStrip + kWin - 1;' in src
    assert 'return (v > m || isnan(v)) ? v : m;' in src
    assert 'const int col = x_left < 0 || x_left + kPoolThreads > W ? reflect(gx, W) : gx;' in src
    assert 'if (y_top < 0 || y_top + kStripRows > H) {' in src
    assert 'for (int k = kWin - 2; k >= 0; --k) h[k] = nan_max(h[k + 1], h[k]);' in src
    assert 's_v[k][u] = nan_max(h[k], g);' in src
    assert 'nan_max(s_v[r][u], s_g[r][u + kWin - 1])' in src


def test_the_cpu_counts_no_launch():
    x = torch.from_numpy(MAPS['21x21'])
    before = segmask.maxpool20.launches
    assert torch.equal(segmask.maxpool20(x), segmask.maxpool20_reference(x))
    assert segmask.maxpool20.launches == before
