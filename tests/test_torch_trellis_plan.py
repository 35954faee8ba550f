"""
The trellis kernel's "warp" route (``csrc/trellis.cu``) modelled in numpy,
and its launch as ``kraken_tpu_torch/ops/trellis.py:plan`` mirrors it.

The model follows the kernel step for step: one warp a line, lane l holding
columns ``l + 32 k`` for k < K in "registers", the left neighbour of each
column taken by one shuffle a k (lane l reads lane l - 1, lane 0 reads lane
31, whose value of k - 1 is its column 32 k - 1), column 0 summed frame by
frame and kept by lane 0, every add rounded to fp32 once, the max
np.maximum's, and each frame's emissions read from its row in shared
memory, where the line's rows come ``CHUNK`` frames at a time (one
contiguous run of floats, 4-byte copies up to its first 16-byte boundary
and after its last, 16-byte copies between) into one of two buffers while
the chunk before is computed. It must give, bit for bit and infinities
included:

- the numpy ``kraken_tpu.align.get_trellis`` of every line of every case
  of ``chip_smoke.py:trellis_batches`` whose batch the warp route takes,
  its route edges included (32, 33, 64, 65, 96 and 256 columns, each
  beside a line of no frame, one of one frame and one of more tokens than
  frames; short lines padded beside a 255-token line);
- the port's plain version (``trellis_reference``) on the same padded
  batches.

``kraken_tpu.align.get_trellis_device`` is held at its own test's
tolerance (rtol 1e-6, equal infinities, ``tests/test_tasks.py``): its XLA
cumsum sums column 0 in another order than numpy, so it is not bit for bit
numpy's; and it compiles once a shape, so a handful of lines is checked.

The plan: every line is taken by exactly one block, shared memory stays
within an H100 block's, the page shapes take the warp route, and the route
edges (256 columns the last warp line, 2,048 the last block line) sit where
the source puts them, with the constants read back from the source (the
``cuda`` test ``test_trellis_geometry_matches_its_plan`` holds the source's
own answer, ``trellis_geometry``, to the plan on the card).
"""
import importlib.util
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import kraken_tpu.align as jax_align
from kraken_tpu_torch.ops import trellis as trellis_ops

ROOT = Path(__file__).resolve().parent.parent
SOURCE = ROOT / 'kraken_tpu_torch' / 'csrc' / 'trellis.cu'
SMEM_PER_BLOCK = 232448   # 227 KB, the most an H100 block can have
F32_INF = np.float32(np.inf)


def _smoke():
    spec = importlib.util.spec_from_file_location('chip_smoke', ROOT / 'chip_smoke.py')
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


SMOKE = _smoke()


def np_maximum(a, b):
    """The kernel's max: a, unless b is larger or NaN."""
    return np.where((a >= b) | np.isnan(a), a, b)


def stage_run(buffer: np.ndarray, src: np.ndarray, offset: int) -> None:
    """The kernel's ``stage_run``: a warp's copy of `src` (at float `offset`
    of a 16-byte aligned tensor) into `buffer` from ``offset % 4`` on, by
    4-byte copies up to the first 16-byte boundary and after the last, and
    16-byte copies between them, each lane's share of each loop; every
    float lands exactly once."""
    count, shift = len(src), offset & 3
    head = min(count, (4 - shift) & 3)
    body = (count - head) // 4
    landed = np.zeros(len(buffer), np.int64)
    for lane in range(32):
        for i in range(lane, head, 32):
            buffer[shift + i] = src[i]
            landed[shift + i] += 1
        for i in range(lane, body, 32):
            assert (offset + head + 4 * i) % 4 == 0 and (shift + head + 4 * i) % 4 == 0
            buffer[shift + head + 4 * i:shift + head + 4 * i + 4] = src[head + 4 * i:head + 4 * i + 4]
            landed[shift + head + 4 * i:shift + head + 4 * i + 4] += 1
        for i in range(head + 4 * body + lane, count, 32):
            buffer[shift + i] = src[i]
            landed[shift + i] += 1
    assert (landed[shift:shift + count] == 1).all() and landed.sum() == count


def warp_line(emission: np.ndarray, tokens: np.ndarray, T: int, L: int, K: int,
              offset: int = 0, chunk: int = trellis_ops.CHUNK) -> tuple[np.ndarray, int]:
    """One warp of the kernel on one line of a padded batch: `emission`
    (T_max, C) and `tokens` (L_max,) the line's padded rows, T and L its
    counts, `offset` the float offset of its emission in the batch. Returns
    the (T_max + 1, L_max + 1) output with the cells the kernel does not
    write left NaN, and the line's error bits."""
    T_max, C = emission.shape
    L_max = tokens.shape[0]
    W = L_max + 1
    out = np.full((T_max + 1, W), np.nan, np.float32)
    lane = np.arange(32)[None, :]
    j = lane + 32 * np.arange(K)[:, None]            # (K, 32): lane l's column of k
    live = (j >= 1) & (j <= L)
    tok = np.where(live, tokens[np.clip(j - 1, 0, L_max - 1)], 0)
    bad = 2 if ((tok < 0) | (tok >= C)).any() else 0
    tok = np.where((tok < 0) | (tok >= C), 0, tok)
    first_inf = T + 1 - L
    row = np.where(j == 0, F32_INF if first_inf <= 0 else np.float32(0),
                   -F32_INF).astype(np.float32)
    stored = j <= L
    out[0, j[stored]] = row[stored]
    # chunk c (frames c * chunk on, one contiguous run of floats) staged
    # into buffer c % 2 while chunk c - 1 is computed; frame t of the chunk
    # read from its row there
    size = (chunk * C + 6) // 4 * 4
    buffers = np.full((2, size), np.nan, np.float32)
    flat = emission.reshape(-1)

    def stage(c):
        f0 = c * chunk
        if f0 < T:
            buffers[c & 1] = np.nan
            stage_run(buffers[c & 1], flat[f0 * C:min(T, f0 + chunk) * C], offset + f0 * C)

    stage(0)
    acc = np.float32(0)
    for c, f0 in enumerate(range(0, T, chunk)):
        stage(c + 1)
        base = (offset + f0 * C) & 3
        for t in range(f0, min(T, f0 + chunk)):
            rows = buffers[c & 1, base + (t - f0) * C:]
            e0, et = rows[0], rows[tok]
            if not np.isfinite(e0):
                bad |= 4
            if not np.isfinite(et[live]).all():
                bad |= 4
            acc = np.float32(acc + e0)
            rot = np.roll(row, 1, axis=1)             # lane l reads lane l - 1 (lane 0: 31)
            left = rot.copy()
            left[1:, 0] = rot[:-1, 0]                 # lane 0 of k: lane 31 of k - 1
            new = np_maximum(row + e0, left + et)
            new[0, 0] = F32_INF if t + 1 >= first_inf else acc
            row = new.astype(np.float32)
            out[t + 1, j[stored]] = row[stored]
    return out, bad


def warp_batch(args) -> list:
    """The model on every line of a padded batch the warp route takes."""
    emission, tokens, frames, lens = (a.numpy() for a in args)
    N, T_max, C = emission.shape
    route, K = trellis_ops.plan(*tokens.shape, C)[:2]
    assert route == 'warp'
    return [warp_line(emission[n], tokens[n], int(T), int(L), K, n * T_max * C)
            for n, (T, L) in enumerate(zip(frames, lens))]


def batch_plan(lines) -> tuple:
    """The plan of a batch of (emission, tokens) lines."""
    return trellis_ops.plan(len(lines), max(len(t) for _, t in lines),
                            max(e.shape[1] for e, _ in lines))


def all_warp_batches() -> dict:
    """Every batch of chip_smoke's trellis cases that the warp route takes
    (its route edges included: ``TRELLIS_COLUMNS``, ``TRELLIS_MIXED``)."""
    return {tag: lines for tag, lines in SMOKE.trellis_batches().items()
            if batch_plan(lines)[0] == 'warp'}


BATCHES = all_warp_batches()


def test_the_cases_cover_every_warp_instance():
    """Every K of the warp route is exercised, and so are the smoke's ragged,
    edge and flagship-like batches that it takes."""
    ks = {batch_plan(b)[1] for b in BATCHES.values()}
    assert ks == {1, 2, 4, 8}
    assert {'flagship', 'mixed', 'cols32', 'cols33', 'cols64', 'cols65', 'cols96',
            'cols256'} <= set(BATCHES) and 'cols257' not in BATCHES
    assert sum(t.startswith('ragged') for t in BATCHES) == SMOKE.TRELLIS_RAGGED


@pytest.mark.parametrize('tag', sorted(BATCHES))
def test_warp_model_equals_numpy_and_the_plain_version(tag):
    lines = BATCHES[tag]
    args = trellis_ops.pad([e for e, _ in lines], [t for _, t in lines], 'cpu')
    ref = trellis_ops.trellis_reference(*args).numpy()
    frames, lens = args[2].tolist(), args[3].tolist()
    for n, ((e, t), (got, bad)) in enumerate(zip(lines, warp_batch(args))):
        T, L = frames[n], lens[n]
        block = got[:T + 1, :L + 1]
        assert bad == 0
        assert np.array_equal(block.view(np.int32), jax_align.get_trellis(e, t).view(np.int32))
        assert np.array_equal(block.view(np.int32), ref[n, :T + 1, :L + 1].view(np.int32))
        # nothing outside the line's block is written
        assert np.isnan(got[T + 1:]).all() and np.isnan(got[:, L + 1:]).all()


@pytest.mark.parametrize('tag', ['cols65', 'mixed', 'ragged3'])
def test_warp_model_within_the_jax_device_form(tag):
    for (e, t), (got, _) in zip(BATCHES[tag][:3], warp_batch(trellis_ops.pad(
            [e for e, _ in BATCHES[tag][:3]], [t for _, t in BATCHES[tag][:3]], 'cpu'))):
        a = got[:e.shape[0] + 1, :len(t) + 1]
        b = np.asarray(jax_align.get_trellis_device(e, t))
        np.testing.assert_array_equal(np.isposinf(a), np.isposinf(b))
        np.testing.assert_array_equal(np.isfinite(a), np.isfinite(b))
        mask = np.isfinite(a)
        np.testing.assert_allclose(a[mask], b[mask], rtol=1e-6)


@pytest.mark.parametrize('chunk', [1, 3, 16])
@pytest.mark.parametrize('offset', [0, 1, 2, 3])
def test_each_frame_reads_its_own_row(chunk, offset):
    """Whatever the chunk and however the line's emission sits against 16
    bytes, each frame reads its own row: 40 frames of 9 classes, chunks that
    divide it and that do not."""
    (e, t), = SMOKE.trellis_lines(7, [(40, 5, 9)])
    args = trellis_ops.pad([e], [t], 'cpu')
    got, _ = warp_line(args[0][0].numpy(), args[1][0].numpy(), 40, 5, 1, offset, chunk)
    assert np.array_equal(got, jax_align.get_trellis(e, t))


def test_warp_model_reports_what_the_kernel_refuses():
    """Error bits: 2 for a token outside the classes (read as class 0), 4
    for an emission the recurrence reads that is not finite; an emission it
    does not read (another class) is never looked at."""
    (e, t), = SMOKE.trellis_lines(8, [(6, 3, 5)])
    e = e.copy()
    e[:, [c for c in range(5) if c not in set(t) | {0}]] = np.nan
    assert warp_line(e, t.astype(np.int32), 6, 3, 1)[1] == 0
    e[2, t[1]] = np.inf
    assert warp_line(e, t.astype(np.int32), 6, 3, 1)[1] == 4
    assert warp_line(e, np.array([1, 7, 2], np.int32), 6, 3, 1)[1] & 2


# ---------------------------------------------------------------- the plan

def lines_taken(N: int, L_max: int, C: int) -> np.ndarray:
    route, _, _, lines, _, blocks = trellis_ops.plan(N, L_max, C)
    taken = np.zeros(N, np.int64)
    for b in range(blocks):
        taken[b * lines:min(b * lines + lines, N)] += 1
    return taken


@pytest.mark.parametrize('N, L_max, C', [(1, 1, 2), (44, 89, 36), (64, 64, 250), (5, 31, 40),
                                         (7, 255, 300), (9, 256, 40), (3, 1030, 6), (2, 2047, 4),
                                         (4, 3000, 40), (130, 20, 97), (6, 50, 5000)])
def test_every_line_is_taken_once(N, L_max, C):
    assert (lines_taken(N, L_max, C) == 1).all()


@pytest.mark.parametrize('C', [2, 36, 250, 453, 454, 1815, 1816, 20000])
@pytest.mark.parametrize('L_max', [1, 31, 32, 63, 64, 127, 128, 255, 256, 1023, 1024, 2047,
                                   2048, 3000, 20000])
def test_a_block_fits_the_card(L_max, C):
    route, k, threads, lines, smem, _ = trellis_ops.plan(8, L_max, C)
    assert smem <= SMEM_PER_BLOCK and threads <= 1024 and threads % 32 == 0
    cols = L_max + 1
    if route == 'warp':   # a lane's K columns cover the line, a warp a line and its ring
        assert 32 * k >= cols > 16 * k or k == 1
        assert threads == 32 * lines
        assert lines == min(trellis_ops.WARP_LINES, SMEM_PER_BLOCK // (2 * (16 * C + 6) // 4 * 16))
        assert smem == lines * 2 * trellis_ops.chunk_floats(C) * 4
    elif route == 'block':   # two rows in shared memory, a thread k columns
        assert threads * k >= cols and smem == 2 * cols * 4
    else:
        assert threads * k >= cols and smem == 0


def test_the_page_shapes_take_the_warp_route():
    """The fixture page's batch (44 lines, 89 tokens at most, 36 classes)
    and the flagship-like batch (64 lines, up to 64 tokens, 250 classes)
    take the warp route, four columns a lane."""
    assert trellis_ops.plan(44, 89, 36) == ('warp', 4, 128, 4, 4 * 2 * 580 * 4, 11)
    assert trellis_ops.plan(64, 64, 250) == ('warp', 4, 128, 4, 4 * 2 * 4004 * 4, 16)


def test_routes_change_where_the_source_puts_them():
    seen = [trellis_ops.plan(3, L, 40)[:2] for L in range(1, 3001)]
    assert [s[0] for s in seen] == ['warp'] * 255 + ['block'] * 1792 + ['long'] * 953
    assert [s[1] for s in seen[:255]] == [1] * 31 + [2] * 32 + [4] * 64 + [8] * 128
    assert seen[1022:1024] == [('block', 1), ('block', 2)]
    # fewer lines a block as the codec grows, and the block route for a codec
    # whose chunks exceed a block's shared memory
    assert [trellis_ops.plan(3, 20, C)[::3] for C in (453, 454, 1815, 1816)] == [
        ('warp', 4), ('warp', 3), ('warp', 1), ('block', 1)]


def test_plan_constants_are_the_kernel_sources():
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf'constexpr int {name} = (\d+);', src).group(1))

    assert const('kWarpMaxK') == trellis_ops.WARP_MAX_K
    assert const('kWarpLines') == trellis_ops.WARP_LINES
    assert const('kMaxThreads') == trellis_ops.MAX_THREADS
    assert const('kMaxColsPerThread') == trellis_ops.COLS_PER_THREAD
    assert 'while (32 * k < cols) k *= 2;' in src
    assert const('kChunk') == trellis_ops.CHUNK
    assert 'inline int chunk_floats(int C) { return (kChunk * C + 3 + 3) / 4 * 4; }' in src
    assert 'const long long warp_bytes = 2LL * chunk_floats(C) * sizeof(float);' in src
    assert 'const int lines = (int)std::min<long long>(kWarpLines, optin / warp_bytes);' in src
    assert 'enum Route { kWarp = 0, kBlock = 1, kLong = 2 };' in src
    assert trellis_ops.ROUTES == ('warp', 'block', 'long')


def test_the_cpu_counts_no_launch():
    (e, t), = SMOKE.trellis_lines(9, [(10, 4, 6)])
    before = (trellis_ops.trellis.launches, dict(trellis_ops.trellis.route_launches))
    out = trellis_ops.trellis(*trellis_ops.pad([e], [t], 'cpu'))
    assert np.array_equal(out[0].numpy(), jax_align.get_trellis(e, t))
    assert (trellis_ops.trellis.launches, trellis_ops.trellis.route_launches) == before
    assert isinstance(out, torch.Tensor)


def test_trellis_variants_apply_to_the_kernel_source():
    """Every version ``chip_smoke.py --trellis-variants`` builds is an edit
    of the kernel source that still finds its text there, exactly once."""
    source = SOURCE.read_text()
    for name, edits in SMOKE.TRELLIS_VARIANTS.items():
        made = SMOKE.trellis_variant_source(name, source)
        assert (made == source) == (not edits), name
    assert set(SMOKE.TRELLIS_SAME) < set(SMOKE.TRELLIS_VARIANTS)
