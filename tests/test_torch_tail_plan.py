"""
The recognition tail kernel's launch as ``kraken_tpu_torch/ops/tail.py:plan``
mirrors it (``csrc/tail.cu`` computes the same in ``tail_geometry``; the
``cuda`` test ``test_tail_geometry_matches_its_mirror`` holds the two
together on the card): every frame is taken by exactly one block, a block's
shared memory stays within what an H100 block can have and leaves room for
two blocks an SM, the flagship's 250 classes get 32-frame tiles, and the
direct route (a warp a frame from device memory) starts just above the
largest C an 8-frame tile holds. The mirror's constants are read back from
the kernel source. Also the two facts the kernel's label rests on: a class
whose e = exp(x / T - m) is below 1 - 2^-20 has a posterior below the
largest, 1 / s, in fp32; and its order-preserving ints sort as the floats
they come from.
"""
import re
from pathlib import Path

import numpy as np
import pytest

from kraken_tpu_torch.ops import tail

SOURCE = Path(tail.__file__).resolve().parent.parent / 'csrc' / 'tail.cu'
SMEM_PER_BLOCK = 232448   # 227 KB, the most an H100 block can have
SMEM_PER_SM = 233472      # 228 KB
THREADS_PER_SM = 2048


def frames_taken(N: int, C: int, W: int) -> np.ndarray:
    """How many blocks take each (n, w) frame, as plan's docstring maps
    blocks to frames."""
    route, F, threads, _, blocks = tail.plan(N, C, W)
    taken = np.zeros((N, W), np.int64)
    if route == 'tile':
        tiles = -(-W // F)
        for b in range(blocks):
            n, w0 = divmod(b, tiles)
            taken[n, w0 * F:min(w0 * F + F, W)] += 1
    else:
        flat = taken.reshape(-1)
        for b in range(blocks):
            flat[b * F:min(b * F + F, N * W)] += 1
    return taken


@pytest.mark.parametrize('N, C, W', [
    (64, 250, 128), (16, 250, 800), (64, 250, 1), (1, 2, 31), (4, 250, 100), (3, 1, 45),
    (3, 1000, 77), (2, 1808, 20), (2, 3615, 9), (2, 3616, 7), (2, 4000, 45), (3, 5000, 1)])
def test_every_frame_is_taken_once(N, C, W):
    assert (frames_taken(N, C, W) == 1).all()


@pytest.mark.parametrize('C', [1, 2, 33, 97, 250, 903, 904, 1000, 1807, 1808, 3000, 3615, 3616,
                               4000, 20000])
def test_shared_memory_fits_a_block_and_two_blocks_an_sm(C):
    route, F, threads, smem, _ = tail.plan(8, C, 100)
    assert smem <= SMEM_PER_BLOCK
    assert 2 * (smem + 1024) <= SMEM_PER_SM
    assert 2 * threads <= THREADS_PER_SM
    if route == 'tile':
        # the tile: F frames of C fp32 logits, the row stride odd
        assert smem == F * (C | 1) * 4 and (C | 1) % 2 == 1


def test_flagship_takes_32_frame_tiles_two_blocks_an_sm():
    route, F, threads, smem, blocks = tail.plan(64, 250, 128)
    assert (route, F, threads, smem, blocks) == ('tile', 32, 512, 32 * 251 * 4, 256)
    assert min(THREADS_PER_SM // threads, SMEM_PER_SM // (smem + 1024)) >= 2


@pytest.mark.parametrize('C, route, F', [
    (903, 'tile', 32), (904, 'tile', 16), (1807, 'tile', 16), (1808, 'tile', 8),
    (tail.MAX_TILE_C, 'tile', 8), (tail.MAX_TILE_C + 1, 'direct', 16), (4000, 'direct', 16)])
def test_direct_route_only_above_its_limit(C, route, F):
    assert tail.plan(2, C, 50)[:2] == (route, F)


def test_routes_change_once_along_c():
    """F falls 32, 16, 8 as C grows, then the direct route takes over for
    good: at no C does a larger codec get larger tiles."""
    seen = [tail.plan(1, C, 64)[:2] for C in range(1, 5001)]
    order = [('tile', 32), ('tile', 16), ('tile', 8), ('direct', 16)]
    assert [order.index(s) for s in seen] == sorted(order.index(s) for s in seen)
    assert seen.index(('direct', 16)) + 1 == tail.MAX_TILE_C + 1


def test_mirror_constants_are_the_kernel_sources():
    src = SOURCE.read_text()

    def const(name):
        return int(re.search(rf'constexpr int {name} = (\d+);', src).group(1))

    assert const('kWarps') == tail.WARPS and const('kMaxFrames') == max(tail.FRAMES)
    assert 'constexpr int kSmemTwoBlocks = 233472 / 2 - 1024;' in src
    assert tail.SMEM_TWO_BLOCKS == 233472 // 2 - 1024
    assert 'for (int f = kMaxFrames; f >= 8; f /= 2)' in src and tail.FRAMES == (32, 16, 8)
    assert 'row_stride(int C) { return C | 1; }' in src


# the kernel's label: the confidence is RN(1 / s) (the posterior at e = 1),
# and only classes with e >= 1 - 2^-20 are divided to see whether they
# equal it
NEAR = np.float32(1) - np.float32(2.0 ** -20)


@pytest.mark.parametrize('seed', range(4))
def test_only_classes_near_the_max_reach_its_posterior(seed):
    rng = np.random.default_rng(seed)
    s = rng.uniform(1, 4000, 200_000).astype(np.float32)
    s[:4] = [1, 2, np.float32(3999.9998), np.nextafter(np.float32(2), np.float32(1))]
    conf = np.float32(1) / s
    below = np.nextafter(NEAR, np.float32(0))
    e = np.concatenate([np.full(100_000, below, np.float32),
                        rng.uniform(0, below, 100_000).astype(np.float32)])
    assert (e / s < conf).all()
    # while the float just below 1 does round to it for some s, so the
    # kernel divides the classes near the max rather than taking e == 1
    assert (np.nextafter(np.float32(1), np.float32(0)) / s == conf).any()


def ordered(x: np.ndarray) -> np.ndarray:
    """The kernel's order-preserving int of a float32 (csrc/tail.cu:ordered)."""
    i = x.view(np.int32)
    return np.where(i >= 0, i, i ^ np.int32(0x7fffffff))


def test_ordered_ints_sort_as_their_floats():
    rng = np.random.default_rng(5)
    x = np.concatenate([rng.normal(0, 30, 10_000), [0.0, -0.0, np.inf, -np.inf, 1e-42, -1e-42,
                                                   3.4e38, -3.4e38]]).astype(np.float32)
    o = ordered(x)
    order = np.argsort(o, kind='stable')
    assert (np.diff(x[order]) >= 0).all()
    assert (ordered(o.view(np.float32)) == x.view(np.int32)).all()   # its own inverse
    assert ordered(x).max() == ordered(np.array([x.max()], np.float32))[0]


def test_tail_variants_apply_to_the_kernel_source():
    """Every version ``chip_smoke.py --tail-variants`` builds is an edit of
    the kernel source that still finds its text there, exactly once."""
    import importlib.util
    spec = importlib.util.spec_from_file_location('chip_smoke', SOURCE.parents[2] / 'chip_smoke.py')
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    source = SOURCE.read_text()
    for name, edits in smoke.TAIL_VARIANTS.items():
        made = smoke.tail_variant_source(name, source)
        assert (made == source) == (not edits), name
    assert set(smoke.TAIL_SAME) < set(smoke.TAIL_VARIANTS)
