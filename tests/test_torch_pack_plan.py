"""
The packed decision masks (``csrc/segmask.cu`` ``pack_masks_kernel``)
modelled in numpy, step for step.

The model follows the kernel's launch (a block of 4 warps; grid: the tiles
of a map over 4, the tasks, the pages; a task a region plane, the
separator pair or a ridge plane; a warp a tile of 8 runs of 32 pixels of 2
rows, its rows and runs from one 32-bit division) and each warp's work: a
lane a pixel of each run, a lane past W loading its row's last pixel and a
row past H the last row (neither stored; lanes past W vote 0); every load
of the tile before its first ballot; the separator task reading both
filtered maps once a pixel and making both planes from that one read
(``__fsub_rn`` then the two compares); a region task's channel from the
int32 table; for each run and row one ``__ballot_sync``; lane 4 q + j
takes run q's ballot, ``__brev`` and ``__byte_perm(.., 0, 0x0123)``
(modelled as the intrinsics are defined) give the run's 4 output bytes in
memory order, and the lane stores byte j: one store a row and plane.

It must give the plain version (``pack_masks_reference``) and the JAX
package's ``_packbits_w`` of the JAX thresholds bit for bit, at widths 1, 7,
8, 9, 31, 32, 33, 354 and 1245, at 0, 4 and 70 region channels, at 1 and 2
pages, at heights that fill the last tile and that do not, with ties at 0.5
and ±0.2, NaN and ±inf in the heatmaps and the filtered maps; every output
byte written exactly once, every pixel of each map read once a plane it
makes (the last column and row once more for each lane and row past the
map); with the constants read back from the source.
"""
import tests.test_torch_threads  # noqa: F401  (first: the thread share under xdist)
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kraken_tpu.inference.segmentation import _packbits_w
from kraken_tpu_torch.ops.segmask import pack_masks, pack_masks_reference

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / 'kraken_tpu_torch' / 'csrc' / 'segmask.cu'

WARPS = 4          # a block's warps, a tile each
RUNS = 8           # a tile: runs of a row ...
ROWS = 2           # ... in rows
RUN = 32           # pixels a run: a lane each
PERM = 0x0123      # __byte_perm's selector: the bytes swapped into memory order
HALF, FIFTH = np.float32(0.5), np.float32(0.2)

WIDTHS = [1, 7, 8, 9, 31, 32, 33, 354, 1245]


def launch(N: int, tasks: int, H: int, W: int) -> tuple[tuple[int, int, int], int, int, int]:
    """The kernel's grid (blocks over a map's tiles, tasks, pages), block,
    tiles a map and strips (tiles) a row."""
    strips = -(-W // (RUNS * RUN))
    tiles = -(-H // ROWS) * strips
    return (-(-tiles // WARPS), tasks, N), WARPS * 32, tiles, strips


def brev(x: np.ndarray) -> np.ndarray:
    """``__brev``: the 32 bits reversed."""
    x = x.astype(np.uint64)
    out = np.zeros_like(x)
    for i in range(32):
        out |= ((x >> np.uint64(i)) & np.uint64(1)) << np.uint64(31 - i)
    return out.astype(np.uint32)


def byte_perm(x: np.ndarray, y: int, s: int) -> np.ndarray:
    """``__byte_perm(x, y, s)``: byte n of the result is byte ``s``'s nibble
    n (0-7) of the 8 bytes ``y:x``."""
    both = (np.uint64(y) << np.uint64(32)) | x.astype(np.uint64)
    out = np.zeros_like(both)
    for n in range(4):
        sel = (s >> (4 * n)) & 7
        out |= ((both >> np.uint64(8 * sel)) & np.uint64(0xff)) << np.uint64(8 * n)
    return out.astype(np.uint32)


def ballot(pred: np.ndarray) -> np.ndarray:
    """``__ballot_sync`` of each warp's (32,) lanes: bit i = lane i."""
    return (pred.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(-1).astype(np.uint32)


class Memory:
    """The output buffer, with the writes of each byte and the store
    instructions issued."""

    def __init__(self, nbytes: int):
        self.bytes = np.zeros(nbytes, np.uint8)
        self.writes = np.zeros(nbytes, np.int64)
        self.stores = 0

    def store_row(self, dst: np.ndarray, st: np.ndarray, lane: np.ndarray, bits: list) -> None:
        """The kernel's ``store_row`` for each warp: lane 4 q + j takes run
        q's ballot of `bits` and, where `st`, stores byte j at `dst`."""
        q = lane >> 2
        b = bits[0][:, None] * np.ones_like(q)
        for k in range(1, RUNS):
            b = np.where(q == k, bits[k][:, None], b)
        word = byte_perm(brev(b), 0, PERM)
        byte = ((word >> (8 * (lane & 3)).astype(np.uint32)) & np.uint32(0xff)).astype(np.uint8)
        np.add.at(self.writes, dst[st], 1)
        self.bytes[dst[st]] = byte[st]
        self.stores += len(dst)


def model(probs: np.ndarray, regions, filt: np.ndarray, ridge: np.ndarray):
    """The kernel on numpy arrays: (output, Memory, reads of each input)."""
    N, C, H, W = probs.shape
    nr, nb = len(regions), ridge.shape[1]
    K, W8 = nr + 2 + nb, -(-W // 8)
    plane = H * W8
    (gx, gy, gz), threads, tiles, strips = launch(N, nr + 1 + nb, H, W)
    assert threads == WARPS * 32 and gz == N
    mem = Memory(N * K * plane)
    reads = {'probs': np.zeros(probs.shape, np.int64), 'filt': np.zeros(filt.shape, np.int64),
             'ridge': np.zeros(ridge.shape, np.int64)}
    lane = np.arange(32)[None, :]
    w = np.arange(gx * WARPS)                  # blockIdx.x * kPackWarps + warp
    w = w[w < tiles]                           # warps past the map return
    g = w // strips                            # one 32-bit division a warp
    s = w - g * strips
    y0, x0 = g * ROWS, s * RUNS * RUN
    # a lane past W loads its row's last pixel, a row past H the last row
    xs = [x0[:, None] + q * RUN + lane for q in range(RUNS)]
    inn = [x < W for x in xs]
    cols = [np.minimum(x, W - 1) for x in xs]
    rows = [np.broadcast_to(np.minimum(y0 + i, H - 1)[:, None], xs[0].shape) for i in range(ROWS)]
    # lane 4 q + j stores byte j of run q of each row
    xb = s[:, None] * RUNS * 4 + lane
    st = (lane < 4 * RUNS) & (xb < W8)

    def load(src, counts):
        tile = []
        for i in range(ROWS):
            for q in range(RUNS):
                np.add.at(counts, (rows[i], cols[q]), 1)
            tile.append([src[rows[i], cols[q]] for q in range(RUNS)])
        return tile

    def store(n, k, i, bits):
        here = st & (y0[:, None] + i < H)
        mem.store_row(n * K * plane + k * plane + (y0[:, None] + i) * W8 + xb, here, lane, bits)

    with np.errstate(invalid='ignore'):
        for n in range(gz):
            for task in range(gy):
                if task == nr:
                    # the separator maps, once: both their planes
                    a = load(filt[n, 0], reads['filt'][n, 0])
                    b = load(filt[n, 1], reads['filt'][n, 1])
                    for i in range(ROWS):
                        d = [a[i][q] - b[i][q] for q in range(RUNS)]    # float32: __fsub_rn
                        store(n, nr, i, [ballot(inn[q] & (d[q] > FIFTH)) for q in range(RUNS)])
                        store(n, nr + 1, i, [ballot(inn[q] & (d[q] < -FIFTH))
                                             for q in range(RUNS)])
                elif task < nr:
                    c = regions[task]
                    v = load(probs[n, c], reads['probs'][n, c])
                    for i in range(ROWS):
                        store(n, task, i, [ballot(inn[q] & (v[i][q] > HALF)) for q in range(RUNS)])
                else:
                    j = task - nr - 1
                    v = load(ridge[n, j], reads['ridge'][n, j])
                    for i in range(ROWS):
                        store(n, nr + 2 + j, i, [ballot(inn[q] & (v[i][q] != 0))
                                                 for q in range(RUNS)])
    return mem.bytes.reshape(N, K, H, W8), mem, reads


def case(N: int, nr: int, W: int, H: int = 5, seed: int = 0):
    """Heatmaps with ties at 0.5, NaN and ±inf; filtered maps whose
    difference lands on ±0.2 exactly, NaN (inf - inf) and ±inf; ridge masks
    of 0, 1, 7 and 255; `nr` region channels of nr + 3, in a shuffled order
    with one repeat."""
    rng = np.random.RandomState(seed + 97 * W + nr)
    C = nr + 3
    probs = (1 / (1 + np.exp(-4 * rng.randn(N, C, H, W)))).astype(np.float32)
    probs[:, :, ::2, ::3] = HALF
    probs[:, :, 1, ::5] = np.nan
    probs[:, :, 2, 1::7] = np.inf
    probs[:, :, 3, 2::7] = -np.inf
    filt = (1 / (1 + np.exp(-4 * rng.randn(N, 2, H, W)))).astype(np.float32)
    filt[:, 0, ::2] = filt[:, 1, ::2] + FIFTH
    filt[:, 1, 1::4] = filt[:, 0, 1::4] + FIFTH
    filt[:, :, 2, ::6] = np.inf
    filt[:, 0, 3, 1::6] = np.nan
    filt[:, 1, 4, ::4] = -np.inf
    ridge = rng.choice(np.array([0, 0, 1, 7, 255], np.uint8), size=(N, 4, H, W))
    regions = [int(c) for c in rng.permutation(C)[:nr]]
    if nr > 1:
        regions[-1] = regions[0]
    return probs, regions, filt, ridge


def jax_masks(probs, regions, filt, ridge) -> np.ndarray:
    """The JAX package's thresholds (inference/segmentation.py:173-184) on
    given filtered maps, packed by its ``_packbits_w``, jitted."""
    def tail(probs, filt, ridge):
        masks = [probs[:, c] > 0.5 for c in regions]
        diff = filt[:, 0] - filt[:, 1]
        masks += [diff > 0.2, diff < -0.2]
        masks += [ridge[:, j] != 0 for j in range(ridge.shape[1])]
        return _packbits_w(jnp.stack(masks, 1))
    return np.asarray(jax.jit(tail)(jnp.asarray(probs), jnp.asarray(filt), jnp.asarray(ridge)))


@pytest.mark.parametrize('N', [1, 2])
@pytest.mark.parametrize('nr', [0, 4, 70])
@pytest.mark.parametrize('W', WIDTHS)
def test_model_equals_the_plain_version_and_jax(W, nr, N):
    H = 5 if N == 1 else 8                 # the last tile part full, and full
    probs, regions, filt, ridge = case(N, nr, W, H=H)
    got, mem, reads = model(probs, regions, filt, ridge)
    want = pack_masks_reference(torch.from_numpy(probs), regions, torch.from_numpy(filt),
                                torch.from_numpy(ridge)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_masks(probs, regions, filt, ridge))
    # every output byte once, in one store a row, plane and tile; each
    # separator map and ridge plane read once a pixel (the last column and
    # row once more for each lane and row past the map), each region
    # channel once a plane it makes
    K = nr + 2 + 4
    assert (mem.writes == 1).all()
    assert mem.stores == N * launch(N, K - 1, H, W)[2] * ROWS * K
    once = np.ones((H, W), np.int64)
    once[-1] += -(-H // ROWS) * ROWS - H
    once[:, -1] *= 1 + -(-W // (RUNS * RUN)) * RUNS * RUN - W
    assert (reads['filt'] == once).all() and (reads['ridge'] == once).all()
    uses = np.bincount(np.asarray(regions, np.int64), minlength=probs.shape[1])
    assert (reads['probs'] == uses[None, :, None, None] * once).all()


@pytest.mark.parametrize('H, W', [(512, 354), (7, 33), (9, 1245), (1, 1)])
def test_a_tile_stores_each_byte_of_its_rows_once(H, W):
    """Lane 4 q + j stores byte j of run q in each of the tile's rows where
    the row and the byte exist: at the page's 45 bytes a row the second
    tile of a row has 13 (19 of 32 lanes idle), at 1245 pixels the fifth
    has 28; a last tile of 1 row (7, 9) stores that row alone."""
    lane = np.arange(32)
    W8, strips = -(-W // 8), -(-W // (RUNS * RUN))
    count = np.zeros((H, W8), np.int64)
    for g in range(-(-H // ROWS)):
        for s in range(strips):
            for i in range(ROWS):
                st = (lane < 4 * RUNS) & (s * RUNS * 4 + lane < W8) & (g * ROWS + i < H)
                if st.any():
                    np.add.at(count, (g * ROWS + i, s * RUNS * 4 + lane[st]), 1)
    assert (count == 1).all()


def test_ballot_to_bytes_puts_the_first_pixel_in_the_top_bit():
    """Lane i's vote lands at bit 7 - i % 8 of output byte i // 8, and the
    byte swap's selector is the one that does it."""
    for i in range(32):
        word = int(byte_perm(brev(np.array([1 << i], np.uint32)), 0, PERM)[0])
        assert word.to_bytes(4, 'little')[i // 8] == 1 << (7 - i % 8)
        assert sum(word.to_bytes(4, 'little')) == 1 << (7 - i % 8)


def test_the_launch():
    """The page (1, 10, 512, 354), 4 region, 4 ridge planes: 9 tasks of
    256 row pairs by 2 strips, 4,608 warps in 1,152 blocks (34.9 warps for
    each of 132 SMs); the full-size spec (1, 10, 1800, 1245): 9 tasks of 900
    by 5, 40,500 warps in 10,125 blocks; two pages: the same blocks twice
    over."""
    assert launch(1, 9, 512, 354) == ((128, 9, 1), 128, 512, 2)
    assert launch(1, 9, 1800, 1245) == ((1125, 9, 1), 128, 4500, 5)
    assert launch(2, 9, 1800, 1245) == ((1125, 9, 2), 128, 4500, 5)
    assert launch(1, 1, 1, 1) == ((1, 1, 1), 128, 1, 1)


def test_plan_constants_are_the_kernel_sources():
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf'constexpr int {name} = (\d+);', src).group(1))

    assert const('kPackWarps') == WARPS
    assert const('kPackRuns') == RUNS
    assert const('kPackRows') == ROWS
    assert 'constexpr int kPackThreads = kPackWarps * 32;' in src
    for line in [
            'for (int k = 1; k < kPackRuns; ++k) b = q == k ? bits[k] : b;',
            'const unsigned word = __byte_perm(__brev(b), 0, 0x0123);',
            'if (st) *dst = (uint8_t)(word >> (8 * (lane & 3)));',
            'for (int q = 0; q < kPackRuns; ++q) v[i][q] = __ldg(src + row[i] + col[q]);',
            'const int w = blockIdx.x * kPackWarps + (threadIdx.x >> 5);',
            'if (w >= tiles) return;',
            'const int task = blockIdx.y, n = blockIdx.z;',
            'const int g = w / strips;', 'const int s = w - g * strips;',
            'const int y0 = g * kPackRows, x0 = s * kPackRuns * 32;',
            'for (int i = 0; i < kPackRows; ++i) row[i] = min(y0 + i, H - 1) * W;',
            'const int x = x0 + q * 32 + lane;', 'in[q] = x < W;', 'col[q] = min(x, W - 1);',
            'const int xb = s * kPackRuns * 4 + lane;',
            'const bool st = lane < 4 * kPackRuns && xb < W8;',
            'load_tile(f, row, col, a);', 'load_tile(f + hw, row, col, b);',
            'const float d = __fsub_rn(a[i][q], b[i][q]);',
            'above[q] = __ballot_sync(~0u, in[q] && d > 0.2f);',
            'below[q] = __ballot_sync(~0u, in[q] && d < -0.2f);',
            'store_row(o + nr * plane + (size_t)i * W8, here, lane, above);',
            'store_row(o + (nr + 1) * plane + (size_t)i * W8, here, lane, below);',
            'const float* src = probs + ((size_t)n * C + __ldg(regions + task)) * hw;',
            'bits[q] = __ballot_sync(~0u, in[q] && v[i][q] > 0.5f);',
            'store_row(o + task * plane + (size_t)i * W8, st && y0 + i < H, lane, bits);',
            'const uint8_t* src = ridge + ((size_t)n * nb + j) * hw;',
            'bits[q] = __ballot_sync(~0u, in[q] && v[i][q] != 0);',
            'store_row(o + (nr + 2 + j) * plane + (size_t)i * W8, st && y0 + i < H, lane, bits);',
            'const int W8 = (W + 7) / 8, strips = (W + kPackRuns * 32 - 1) / (kPackRuns * 32);',
            'const long long tiles = (long long)((H + kPackRows - 1) / kPackRows) * strips;',
            'const dim3 blocks((unsigned)((tiles + kPackWarps - 1) / kPackWarps), '
            '(unsigned)(nr + 1 + nb),']:
        assert line in src, line
    kernel = src[src.index('pack_masks_kernel('):src.index('// values outside [0, 255]')]
    # no 64-bit index is divided: the one division is of two ints
    assert kernel.count(' / ') == 1 and ' % ' not in kernel and 'long long' not in kernel


def test_the_cpu_counts_no_launch():
    probs, regions, filt, ridge = case(1, 4, 33)
    args = (torch.from_numpy(probs), regions, torch.from_numpy(filt), torch.from_numpy(ridge))
    before = pack_masks.launches
    assert torch.equal(pack_masks(*args), pack_masks_reference(*args))
    assert pack_masks.launches == before
