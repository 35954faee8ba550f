"""
Device line extraction and the byte input transfers of the port
(kraken_tpu_torch.inference.extraction, ops/extract.py,
``line_extraction='device'``, ``input_transfer='uint8'|'packed'``,
``kraken ocr --transfer bytes``) against the JAX package on the CPU, with
inputs made from the fixtures:

- the host half (``baseline_line_desc`` in its straight, mesh and legacy
  branches, ``bbox_line_desc``, ``host_line_desc``,
  ``build_extract_payload``) gives the JAX package's descriptors and
  payloads, array for array;
- the plain gather-warp (``extract_batch_reference``) equals the JAX
  ``extract_batch_jnp`` run op by op, bit for bit (at ss 1 to 4; the page
  and the atlas given apart as one buffer given whole), and is within 1e-5 of
  it jitted (as the JAX forward runs it) on at least 99.9% of the pixels,
  the rest within 1e-4 (XLA's FMA contraction of the coordinates) or near
  a threshold of an envelope test or a floor;
- the plain packed gather equals the JAX ``fwd_packed`` gather bit for bit
  (run op by op; under ``jit`` XLA divides by 255 as a multiply by the fp32
  reciprocal, an ulp off on some bytes, which the port does not copy);
- ``predict`` with ``line_extraction='device'`` gives the JAX device
  route's records on the seven cases of tests/test_extraction.py;
  ``'packed'`` equals ``'uint8'`` in the port, confidences bit for bit;
  the bytes uploaded equal JAX's on every route;
- ``ocr --transfer bytes`` writes the JAX CLI's text.

The kernels themselves are held to these plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 25).
"""
import tests.test_torch_threads  # noqa: F401  (first: the thread share under xdist)
import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

from kraken_tpu.configs import RecognitionInferenceConfig as JaxConfig
from kraken_tpu.containers import BaselineLine as JaxBaselineLine
from kraken_tpu.containers import BBoxLine as JaxBBoxLine
from kraken_tpu.containers import Segmentation as JaxSegmentation
from kraken_tpu.inference import extraction as jax_extraction
from kraken_tpu.lib import telemetry as jax_telemetry
from kraken_tpu.models import load_models as jax_load_models
from kraken_tpu_torch.configs import RecognitionInferenceConfig
from kraken_tpu_torch.containers import Segmentation
from kraken_tpu_torch.inference import extraction
from kraken_tpu_torch.lib import telemetry
from kraken_tpu_torch.models import load_models
from kraken_tpu_torch.ops.extract import (extract_batch, extract_batch_reference, extract_margins,
                                          packed_gather, packed_gather_reference)
from tests.test_serialization import load_ref_pickle

BL_GOLD = '.ܗ ܣܗܐ  ܕ ܣ   ܗ ܕܗܗ ܟܕܗܣ    ܠ  ܐ .ܣܕܐܣ. ܗ '
BBOX_GOLD = 'ܡ ܘܡ ܗ ܡܕܐ ܐ ܐܐ ܡ ܗܗܐܐܐܕ'
LINE_ENDS = (2543, 1800, 1200, 900, 2543)
# plain gather-warp against the jitted JAX program, which contracts
# products into FMAs and divides by 255 as a multiply by the reciprocal
# (see test_extract_reference_matches_jax_jitted)
WARP_ATOL = 1e-5
WARP_SHARE = 0.999
NEAR_THRESHOLD = 1e-4
JITTED_ATOL = 1e-4
# records of the port against the JAX package: the same batches through
# the same network, which sums its convolutions in another order than XLA
# (overfit.mlmodel's confidences on the fixture line are 1.09e-5 apart on
# the float route, which this slice leaves as it was)
CONF_ATOL = 2e-5


@pytest.fixture(scope='module', autouse=True)
def quiet():
    warnings.filterwarnings('ignore', category=DeprecationWarning)
    warnings.filterwarnings('ignore', category=UserWarning)


@pytest.fixture(scope='module')
def line_im(resources):
    return Image.open(resources / '000236.png')


@pytest.fixture(scope='module')
def arabic(resources):
    """The Arabic fixture page in grey and its 24 curved baselines (the
    JAX Segmentation and the port's)."""
    full = load_ref_pickle(resources / 'arabic_seg.pkl')
    jseg = JaxSegmentation(type='baselines', imagename=full.imagename, lines=full.lines,
                           text_direction='horizontal-lr', script_detection=False)
    im = Image.open(resources / 'arabic.webp')
    return im, jseg, Segmentation(**dataclasses.asdict(jseg))


def _bl_seg(resources, ends=(2543,), seg_cls=Segmentation, line_cls=None):
    from kraken_tpu_torch.containers import BaselineLine
    line_cls = line_cls or BaselineLine
    return seg_cls(type='baselines', imagename=resources / 'bw.png',
                   text_direction='horizontal-lr', script_detection=False,
                   lines=[line_cls(id=f'l{i}', baseline=[[0, 10], [x1, 10]],
                                   boundary=[[0, 0], [x1, 0], [x1, 155], [0, 155]])
                          for i, x1 in enumerate(ends)])


def _both_segs(resources, ends=(2543,)):
    return (_bl_seg(resources, ends),
            _bl_seg(resources, ends, JaxSegmentation, JaxBaselineLine))


# ------------------------------------------------------------- host half

DESC_FIELDS = ('grid', 'mask', 'W_l', 'seq_len', 'width', 'shape', 'page_off', 'scale_y',
               'ss_on', 'pad')


def _same_desc(ours, theirs) -> None:
    assert (ours is None) == (theirs is None)
    if ours is None:
        return
    np.testing.assert_array_equal(ours.strip, theirs.strip)
    for f in DESC_FIELDS:
        a, b = getattr(ours, f), getattr(theirs, f)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b, err_msg=f)
        else:
            assert a == b, f


def _gray(im) -> np.ndarray:
    return np.asarray(im.convert('L'))


@pytest.mark.parametrize('legacy', [False, True], ids=['mesh-and-straight', 'legacy'])
@pytest.mark.parametrize('height', [30, 120])
def test_baseline_line_desc_equals_jax(arabic, legacy, height):
    """The straight (line 6: a two-point baseline), mesh and legacy
    Delaunay branches, downscaled (30) and upscaled (120)."""
    im, jseg, seg = arabic
    page = _gray(im)
    straight = 0
    for jline, line in zip(jseg.lines, seg.lines):
        straight += len(line.baseline) == 2
        _same_desc(extraction.baseline_line_desc(page, line, height, 16, legacy=legacy),
                   jax_extraction.baseline_line_desc(page, jline, height, 16, legacy=legacy))
    assert straight == 1


def test_invalid_lines_give_no_desc(resources, line_im):
    from kraken_tpu_torch.containers import BaselineLine
    page = np.asarray(line_im)
    bad = [dict(baseline=[[0, 10], [4000, 10]],
                boundary=[[0, 0], [4000, 0], [4000, 155], [0, 155]]),
           dict(baseline=[[0, 10], [3, 10]], boundary=[[0, 0], [3, 0], [3, 155], [0, 155]]),
           dict(baseline=[[0, 10], [100, 10]], boundary=None)]
    for kw in bad:
        assert extraction.baseline_line_desc(page, BaselineLine(id='x', **kw), 30, 1) is None
        assert jax_extraction.baseline_line_desc(page, JaxBaselineLine(id='x', **kw), 30, 1) is None


@pytest.mark.parametrize('box', [(0, 0, 2544, 156), (100, 20, 900, 120), (0, 0, 2545, 156)])
def test_bbox_line_desc_equals_jax(line_im, box):
    from kraken_tpu_torch.containers import BBoxLine
    page = np.asarray(line_im)
    _same_desc(extraction.bbox_line_desc(page, BBoxLine(id='b', bbox=list(box)), 48, 4),
               jax_extraction.bbox_line_desc(page, JaxBBoxLine(id='b', bbox=list(box)), 48, 4))


def test_host_line_desc_equals_jax(resources):
    """The pass-through of a host-extracted line of a bitonal page."""
    from kraken_tpu_torch.dataset import ImageInputTransforms
    line = Image.open(resources / 'bw.png').convert('1').crop((0, 0, 700, 60))
    ts = ImageInputTransforms(1, 30, 0, 1, (16, 0), False)(line)
    _same_desc(extraction.host_line_desc(ts, line.width, 30, 16),
               jax_extraction.host_line_desc(ts, line.width, 30, 16))


def _descs(pkg, page, lines, height, legacy=False):
    return [d for d in (pkg.baseline_line_desc(page, line, height, 16, legacy=legacy)
                        for line in lines) if d is not None]


def _payload(pkg, descs, page, page_resident, n=None, max_w=None):
    """A payload of `descs` with every `page_resident`-th line gathering
    from the page buffer (the rest packed as strips)."""
    from kraken_tpu.inference.recognition import width_bucket
    max_w = max_w or width_bucket(max(d.seq_len for d in descs))
    page_len = page.size + 37
    offs = [d.page_off if page_resident and i % page_resident == 0 else -1
            for i, d in enumerate(descs)]
    atlas, grid, mask, meta = pkg.build_extract_payload(descs, max_w, n or len(descs), 16,
                                                         page_len, page.shape[1], offs)
    buf = np.concatenate([page.reshape(-1), np.zeros(37, np.uint8), atlas])
    return buf, grid, mask, meta, max_w


def test_build_extract_payload_equals_jax(arabic):
    im, jseg, seg = arabic
    page = _gray(im)
    ours = _payload(extraction, _descs(extraction, page, seg.lines, 30), page, 2, n=32)
    theirs = _payload(jax_extraction, _descs(jax_extraction, page, jseg.lines, 30), page, 2, n=32)
    for a, b in zip(ours, theirs):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------- the gather-warp

@pytest.fixture(scope='module')
def jax_warp():
    return jax.jit(jax_extraction.extract_batch_jnp, static_argnums=(4, 5, 6))


def _quarter(arabic, n: int):
    """The Arabic page at a quarter of its size and its first `n` lines
    (about 20 px high: upscaled to 30 without supersampling)."""
    im, _, seg = arabic
    lines = [dataclasses.replace(line, baseline=[[x // 4, y // 4] for x, y in line.baseline],
                                 boundary=[[x // 4, y // 4] for x, y in line.boundary])
             for line in seg.lines[:n]]
    return _gray(im.resize((im.width // 4, im.height // 4))), lines


def _boxes(resources, height: int) -> list:
    from kraken_tpu_torch.containers import BBoxLine
    line_page = np.asarray(Image.open(resources / '000236.png'))
    return [extraction.bbox_line_desc(line_page, BBoxLine(id='b', bbox=list(b)), height, 4)
            for b in ((0, 0, 2544, 156), (100, 20, 900, 120), (300, 0, 340, 156))]


def _passes(resources) -> list:
    """Host pass-throughs (identity grids) of lines of a bitonal page."""
    from kraken_tpu_torch.dataset import ImageInputTransforms
    bw = Image.open(resources / 'bw.png').convert('1')
    transforms = ImageInputTransforms(1, 30, 0, 1, (16, 0), False)
    return [extraction.host_line_desc(transforms(bw.crop(box)), box[2] - box[0], 30, 16)
            for box in ((0, 0, 700, 60), (0, 200, 924, 300), (50, 500, 300, 540))]


def _warp_cases(arabic, resources):
    """(tag, buf, grid, mask, meta, max_w, height): the Arabic page's lines
    (mesh and straight; legacy) downscaled with supersampling (30, 48), half
    of them page-resident and half packed, with batch-pad rows; bbox lines
    of the fixture line; host pass-throughs."""
    im, _, seg = arabic
    page = _gray(im)
    cases = []
    for tag, lines, height, legacy in (('arabic-30', seg.lines[:12], 30, False),
                                       ('arabic-48-legacy', seg.lines[:6], 48, True)):
        descs = _descs(extraction, page, lines, height, legacy)
        cases.append((tag, *_payload(extraction, descs, page, 2, n=len(descs) + 3), height))
    cases.append(('bbox', *_payload(extraction, _boxes(resources, 48),
                                    np.zeros((1, 1), np.uint8), 0), 48))
    cases.append(('host-pass-through', *_payload(extraction, _passes(resources),
                                                 np.zeros((1, 1), np.uint8), 0, n=4), 30))
    return cases


def test_extract_reference_equals_jax_op_by_op(arabic, resources):
    """The plain gather-warp rounds every operation as the JAX function
    does when JAX runs it op by op: equal bit for bit on one batch of every
    kind of line (height 30): the Arabic page's lines 4-7 (mesh, and the
    straight one) with supersampling, 3 with legacy polygons, 3 upscaled
    without, every other one of them gathering from the page; 3 bbox lines
    and 3 host pass-throughs as packed strips; 2 batch-pad rows."""
    im, _, seg = arabic
    page = _gray(im)
    quarter, small = _quarter(arabic, 3)
    descs = (_descs(extraction, page, seg.lines[4:8], 30)
             + _descs(extraction, page, seg.lines[:3], 30, legacy=True))
    offs = [d.page_off if i % 2 == 0 else -1 for i, d in enumerate(descs)]
    descs += _descs(extraction, quarter, small, 30) + _boxes(resources, 30) + _passes(resources)
    offs += [-1] * (len(descs) - len(offs))
    max_w, height = 1024, 30
    atlas, grid, mask, meta = extraction.build_extract_payload(
        descs, max_w, len(descs) + 2, 16, page.size, page.shape[1], offs)
    buf = np.concatenate([page.reshape(-1), atlas])
    assert len(descs) == 16 and sorted(set(meta[:len(descs), 7])) == [0, 1]
    ours = extract_batch_reference(*(torch.from_numpy(a) for a in (buf, grid, mask, meta)),
                                   max_w, height).numpy()
    with jax.disable_jit():
        theirs = np.asarray(jax_extraction.extract_batch_jnp(
            jnp.asarray(buf), jnp.asarray(grid), jnp.asarray(mask), jnp.asarray(meta), max_w,
            height, 2))
    assert ours.shape == theirs.shape == (len(meta), 1, height, max_w)
    assert ours.tobytes() == theirs.tobytes()


def test_extract_reference_matches_jax_jitted(arabic, resources, jax_warp):
    """Against the JAX program as its forward runs it (jitted, where XLA
    contracts the lerps into FMAs): within WARP_ATOL on WARP_SHARE of the
    pixels of every case. A pixel beyond that lies on a steep edge, where
    an ulp of a source coordinate several hundred pixels from the strip's
    origin (6e-5 px at 700) moves the sample; or a test or floor of the
    plain version lies within NEAR_THRESHOLD of its threshold. Either way
    within JITTED_ATOL, or near a threshold."""
    report = {}
    for tag, buf, grid, mask, meta, max_w, height in _warp_cases(arabic, resources):
        args = [torch.from_numpy(a) for a in (buf, grid, mask, meta)]
        ours = extract_batch_reference(*args, max_w, height).numpy()
        theirs = np.asarray(jax_warp(jnp.asarray(buf), jnp.asarray(grid), jnp.asarray(mask),
                                     jnp.asarray(meta), max_w, height, 2))
        diff = np.abs(ours - theirs)
        far = diff > WARP_ATOL
        near = (extract_margins(*args, max_w, height).numpy() < NEAR_THRESHOLD if far.any()
                else far)
        report[tag] = (int(far.sum()), int((far & near).sum()), ours.size, float(diff.max()))
        assert far.sum() <= (1 - WARP_SHARE) * ours.size, (tag, report[tag])
        assert not (far & ~near & (diff > JITTED_ATOL)).any(), (tag, report[tag])
    # (pixels beyond WARP_ATOL, of them near a threshold, pixels, max diff)
    print('plain gather-warp against the jitted JAX program:', report)
    # the host pass-throughs sample the identity grid at the pixel centres
    assert report['host-pass-through'][0] == 0, report


def test_extract_batch_on_cpu_is_the_reference(arabic):
    im, _, seg = arabic
    page = _gray(im)
    buf, grid, mask, meta, max_w = _payload(extraction, _descs(extraction, page, seg.lines[:4], 30),
                                            page, 2)
    args = [torch.from_numpy(a) for a in (buf, grid, mask, meta)]
    launches = extract_batch.launches
    for dtype in (torch.float32, torch.bfloat16):
        out = extract_batch(*args, max_w, 30, dtype=dtype)
        assert out.dtype == dtype
        assert torch.equal(out, extract_batch_reference(*args, max_w, 30, dtype=dtype))
    assert extract_batch.launches == launches


def _jax_op_by_op(buf, grid, mask, meta, max_w, height, ss):
    with jax.disable_jit():
        return np.asarray(jax_extraction.extract_batch_jnp(
            jnp.asarray(buf), jnp.asarray(grid), jnp.asarray(mask), jnp.asarray(meta), max_w,
            height, ss))


def _seeded_split_payload(seed: int, height: int = 24):
    """A seeded page of 40 x 60 bytes and atlas of 3000 and a batch over
    them: a line inside the page, a strip starting exactly at the page's
    length, a strip whose window runs past the buffer's last byte (indices
    clamped there), a page line whose window runs on into the atlas, a
    line at a negative offset (indices counted from the end), a batch-pad
    row; random warps, half of them supersampled, points beyond
    their strips' edges. Returns (page, atlas, grid, mask, meta, max_w)."""
    rng = np.random.default_rng(seed)
    page = rng.integers(0, 256, (40, 60), dtype=np.uint8)
    atlas = rng.integers(0, 256, 3000, dtype=np.uint8)
    page_len, total = page.size, page.size + atlas.size
    # (offset, w, h, stride) a line
    windows = [(2 * 60 + 3, 50, 20, 60), (page_len, 40, 25, 40), (total - 300, 30, 20, 30),
               (page_len - 3 * 60 + 5, 45, 6, 60), (-70, 30, 5, 60)]
    n = len(windows) + 1
    grid = np.zeros((n, 129, 3, 3), np.float32)
    grid[:, :, 1, 2], grid[:, :, 2, 2] = 1.0, 2.0
    mask = np.zeros((n, 65, 2), np.float32)
    meta = np.zeros((n, 8), np.int32)
    meta[:, 1:3], meta[:, 4], meta[:, 6] = 1, 64, 1
    for i, (off, w, h, stride) in enumerate(windows):
        W_l = int(rng.integers(20, 48))
        x0, x1 = rng.uniform(-2, 3), rng.uniform(w - 3, w + 2)
        grid[i, :, :, 0] = np.linspace(x0, x1, 129, dtype=np.float32)[:, None] \
            + rng.uniform(-1, 1, (1, 3)).astype(np.float32)
        grid[i, :, :, 1] = np.float32([rng.uniform(-2, 1), rng.uniform(h / 3, 2 * h / 3),
                                       rng.uniform(h - 2, h + 1)])
        grid[i, :, :, 2] = np.float32([0, rng.uniform(height / 3, 2 * height / 3), height - 1])
        mask[i, :, 0] = rng.uniform(-1, 4, 65)
        mask[i, :, 1] = rng.uniform(height - 5, height + 1, 65)
        meta[i] = (off, w, h, W_l, W_l + 32, 16, stride, i % 2)
    return page.reshape(-1), atlas, grid, mask, meta, 96


@pytest.mark.parametrize('seed', range(3))
def test_split_buffer_equals_whole_and_jax(seed):
    """The page and the atlas given apart (as the engine passes them to the
    kernel) give the batch of their concatenation, which equals the JAX
    function op by op, bit for bit, on every kind of window: inside the
    page, a strip at exactly the page's length, indices clamped at the
    buffer's last byte, a page line running on into the atlas, negative
    indices (jnp counts them from the end)."""
    from kraken_tpu_torch.ops.extract import window_routes
    page, atlas, grid, mask, meta, max_w = _seeded_split_payload(seed)
    assert window_routes(meta, page.size, atlas.size) == ['page', 'atlas', 'clamped', 'clamped',
                                                          'clamped', 'pad']
    assert meta[1, 0] == page.size and meta[2, 0] + (meta[2, 2] - 1) * meta[2, 6] + meta[2, 1] \
        > page.size + atlas.size
    t = [torch.from_numpy(a) for a in (grid, mask, meta)]
    split = extract_batch(torch.from_numpy(page), *t, max_w, 24, atlas=torch.from_numpy(atlas))
    whole = np.concatenate([page, atlas])
    assert torch.equal(split, extract_batch(torch.from_numpy(whole), *t, max_w, 24))
    theirs = _jax_op_by_op(whole, grid, mask, meta, max_w, 24, 2)
    assert split.numpy().tobytes() == theirs.tobytes()
    # a buffer of the atlas alone: the page empty
    shifted = meta.copy()
    shifted[:5, 0] -= page.size
    ours = extract_batch(torch.zeros(0, dtype=torch.uint8), *t[:2], torch.from_numpy(shifted),
                         max_w, 24, atlas=torch.from_numpy(atlas))
    assert ours.numpy().tobytes() == _jax_op_by_op(atlas, grid, mask, shifted, max_w, 24,
                                                   2).tobytes()


@pytest.mark.parametrize('ss', [1, 3, 4])
def test_extract_reference_equals_jax_at_other_ss(arabic, ss):
    """The plain gather-warp at the supersampling factors the path does not
    use (1, and 3 whose mean is a division; 4) equals the JAX function op
    by op, bit for bit: 3 of the Arabic page's lines (mesh, one from the
    page), one with legacy polygons, a seeded split payload."""
    im, _, seg = arabic
    page = _gray(im)
    descs = (_descs(extraction, page, seg.lines[4:7], 30)
             + _descs(extraction, page, seg.lines[:1], 30, legacy=True))
    offs = [d.page_off if i == 0 else -1 for i, d in enumerate(descs)]
    max_w = 1024
    atlas, grid, mask, meta = extraction.build_extract_payload(
        descs, max_w, len(descs) + 1, 16, page.size, page.shape[1], offs)
    buf = np.concatenate([page.reshape(-1), atlas])
    ours = extract_batch(torch.from_numpy(page.reshape(-1)),
                         *(torch.from_numpy(a) for a in (grid, mask, meta)), max_w, 30, ss=ss,
                         atlas=torch.from_numpy(atlas)).numpy()
    assert ours.tobytes() == _jax_op_by_op(buf, grid, mask, meta, max_w, 30, ss).tobytes()
    page, atlas, grid, mask, meta, max_w = _seeded_split_payload(ss)
    ours = extract_batch(torch.from_numpy(page), *(torch.from_numpy(a) for a in (grid, mask, meta)),
                         max_w, 24, ss=ss, atlas=torch.from_numpy(atlas)).numpy()
    assert ours.tobytes() == _jax_op_by_op(np.concatenate([page, atlas]), grid, mask, meta, max_w,
                                           24, ss).tobytes()


def test_extract_batch_refuses_a_buffer_past_32_bit_offsets():
    """The kernel addresses a line's bytes by 32-bit offsets: a page and
    atlas of more than MAX_BYTES together are refused on either device
    (the tensors here are broadcast views, no memory behind them)."""
    from kraken_tpu_torch.ops.extract import MAX_BYTES
    grid, mask = torch.zeros((1, 129, 3, 3)), torch.zeros((1, 65, 2))
    meta = torch.zeros((1, 8), dtype=torch.int32)
    page = torch.zeros(1, dtype=torch.uint8).expand(MAX_BYTES - 7)
    with pytest.raises(ValueError, match='32-bit'):
        extract_batch(page, grid, mask, meta, 16, 8, atlas=torch.zeros(8, dtype=torch.uint8))
    with pytest.raises(ValueError, match='empty'):
        extract_batch(torch.zeros(0, dtype=torch.uint8), grid, mask, meta, 16, 8)


@pytest.mark.parametrize('bad', ['grid', 'meta', 'ss'])
def test_extract_batch_refuses_bad_shapes(bad):
    buf = torch.zeros(100, dtype=torch.uint8)
    grid = torch.zeros((2, 129, 3, 3) if bad != 'grid' else (2, 128, 3, 3))
    mask = torch.zeros((2, 65, 2))
    meta = torch.zeros((2, 8) if bad != 'meta' else (3, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        extract_batch(buf, grid, mask, meta, 16, 8, ss=5 if bad == 'ss' else 2)


# ---------------------------------------------------------- packed gather

def test_divide_is_an_ieee_division():
    """``divide`` rounds the quotient once; a multiply by the fp32
    reciprocal of 255 (torch's way with a CUDA tensor over a Python number,
    and XLA's under jit) is an ulp off on 126 of the 256 byte values."""
    from kraken_tpu_torch.ops.extract import divide
    v = np.arange(256, dtype=np.float32)
    exact = v / np.float32(255)
    assert divide(torch.from_numpy(v), 255.0).numpy().tobytes() == exact.tobytes()
    assert int((v * (np.float32(1) / np.float32(255)) != exact).sum()) == 126



def _atlas(seed: int, widths, h=30, c=1):
    rng = np.random.default_rng(seed)
    total = sum(widths)
    atlas = np.zeros((c, h, total + 40), np.uint8)
    atlas[:, :, :total] = rng.integers(0, 256, (c, h, total), dtype=np.uint8)
    n = 1 << (len(widths) - 1).bit_length()
    aux = np.zeros((3, n), np.int32)
    aux[0, :len(widths)] = np.cumsum([0, *widths[:-1]])
    aux[1, :len(widths)] = widths
    aux[2] = max(widths)
    aux[2, :len(widths)] = widths
    return atlas, aux


def _jax_packed_gather(atlas, aux, max_w):
    """The gather of the JAX package's fwd_packed
    (kraken_tpu/inference/recognition.py:164-170), op by op."""
    off, wid = jnp.asarray(aux[0]), jnp.asarray(aux[1])
    xs = jnp.arange(max_w, dtype=jnp.int32)
    idx = jnp.clip(off[:, None] + xs[None, :], 0, atlas.shape[-1] - 1)
    batch = jnp.transpose(jnp.asarray(atlas)[:, :, idx], (2, 0, 1, 3))
    mask = xs[None, :] < wid[:, None]
    batch = jnp.where(mask[:, None, None, :], batch, 0)
    return batch.astype(jnp.float32) / 255.0


@pytest.mark.parametrize('seed, widths, c', [(0, (200, 31, 128, 7, 90), 1), (1, (256,), 1),
                                             (2, (17, 300, 5), 3)])
def test_packed_gather_equals_jax(seed, widths, c):
    atlas, aux = _atlas(seed, widths, c=c)
    max_w = 320
    ours = packed_gather_reference(torch.from_numpy(atlas), torch.from_numpy(aux), max_w).numpy()
    with jax.disable_jit():
        theirs = np.asarray(_jax_packed_gather(atlas, aux, max_w))
    np.testing.assert_array_equal(ours, theirs)
    # jitted, XLA multiplies by the fp32 reciprocal of 255: an ulp at most
    jitted = np.asarray(jax.jit(_jax_packed_gather, static_argnums=2)(atlas, aux, max_w))
    assert np.abs(ours - jitted).max() <= np.spacing(np.float32(1))
    assert packed_gather(torch.from_numpy(atlas), torch.from_numpy(aux), max_w).numpy().tobytes() \
        == ours.tobytes()


# ------------------------------------------------------- records vs JAX

def _predict_both(resources, model_file, im, segs, **cfg):
    """Records of the port and of the JAX package (padding 1, batch 8,
    in-process extraction, as tests/test_extraction.py), with the bytes
    each uploaded."""
    out = []
    for load, config, seg, tele in ((load_models, RecognitionInferenceConfig, segs[0], telemetry),
                                    (jax_load_models, JaxConfig, segs[1], jax_telemetry)):
        model = load(resources / model_file)[0]
        model.prepare_for_inference(config(num_line_workers=0, batch_size=8, padding=1,
                                           device='cpu', **cfg))
        with tele.collect() as stats:
            records = list(model.predict(im, seg))
        out.append((model, records, stats))
    return out


def _same_records(ours, theirs) -> None:
    assert len(ours) == len(theirs)
    for a, b in zip(ours, theirs):
        assert a.prediction == b.prediction
        assert a.cuts == b.cuts
        np.testing.assert_allclose(a.confidences, b.confidences, atol=CONF_ATOL)


def test_device_route_straight_line_golden(resources, line_im):
    (model, ours, _), (_, theirs, _) = _predict_both(resources, 'overfit.mlmodel', line_im,
                                                     _both_segs(resources),
                                                     line_extraction='device')
    assert extraction.supports_device_extraction(model, model._inf_config, 'baselines')
    assert ours[0].prediction == BL_GOLD
    _same_records(ours, theirs)


def test_device_route_arabic_equals_jax(resources, arabic):
    im, jseg, seg = arabic
    (_, ours, ts), (_, theirs, tj) = _predict_both(resources, 'overfit_bl_newpoly.safetensors',
                                                   im, (seg, jseg), line_extraction='device')
    assert len(ours) == 24
    _same_records(ours, theirs)
    assert ts.up_bytes == tj.up_bytes


def test_device_route_legacy_polygons_equal_jax(resources, arabic):
    im, jseg, seg = arabic
    jseg8 = dataclasses.replace(jseg, lines=jseg.lines[:8])
    seg8 = dataclasses.replace(seg, lines=seg.lines[:8])
    (model, ours, _), (_, theirs, _) = _predict_both(resources, 'overfit_bl.safetensors', im,
                                                     (seg8, jseg8), line_extraction='device')
    assert model.use_legacy_polygons
    _same_records(ours, theirs)


def test_device_route_bbox_falls_back_to_host(resources, line_im):
    from kraken_tpu_torch.containers import BBoxLine
    segs = [cls(type='bbox', imagename=resources / 'bw.png', text_direction='horizontal-lr',
                script_detection=False, lines=[line(id='foo', bbox=[0, 0, 2544, 156])])
            for cls, line in ((Segmentation, BBoxLine), (JaxSegmentation, JaxBBoxLine))]
    (model, ours, _), (_, theirs, _) = _predict_both(resources, 'overfit.mlmodel', line_im, segs,
                                                     line_extraction='device')
    assert not extraction.supports_device_extraction(model, model._inf_config, 'bbox')
    assert ours[0].prediction == BBOX_GOLD
    _same_records(ours, theirs)


def test_device_route_bitonal_passthrough(resources):
    im = Image.open(resources / 'bw.png').convert('1')
    (_, ours, ts), (_, theirs, tj) = _predict_both(resources, 'overfit.mlmodel', im,
                                                   _both_segs(resources),
                                                   line_extraction='device')
    _same_records(ours, theirs)
    assert ts.up_bytes == tj.up_bytes


def test_device_route_invalid_lines_give_empty_records(resources, line_im):
    from kraken_tpu_torch.containers import BaselineLine
    kw = [dict(id='bad', baseline=[[0, 10], [4000, 10]],
               boundary=[[0, 0], [4000, 0], [4000, 155], [0, 155]]),
          dict(id='good', baseline=[[0, 10], [2543, 10]],
               boundary=[[0, 0], [2543, 0], [2543, 155], [0, 155]])]
    segs = [cls(type='baselines', imagename=resources / 'bw.png', text_direction='horizontal-lr',
                script_detection=False, lines=[line(**k) for k in kw])
            for cls, line in ((Segmentation, BaselineLine), (JaxSegmentation, JaxBaselineLine))]
    (_, ours, _), (_, theirs, _) = _predict_both(resources, 'overfit.mlmodel', line_im, segs,
                                                 line_extraction='device')
    assert [r.prediction for r in ours] == ['', BL_GOLD]
    _same_records(ours, theirs)


def test_device_route_return_line_image_falls_back(resources, line_im):
    (model, ours, _), (_, theirs, _) = _predict_both(resources, 'overfit.mlmodel', line_im,
                                                     _both_segs(resources),
                                                     line_extraction='device',
                                                     return_line_image=True)
    assert not extraction.supports_device_extraction(model, model._inf_config, 'baselines')
    assert ours[0].prediction == BL_GOLD and ours[0].image is not None
    _same_records(ours, theirs)


def test_device_route_mixes_page_lines_and_strips_across_pages(resources, arabic):
    """The streaming engine's batches span pages: lines of the page whose
    buffer the batch reads gather from it, the others pack their strips;
    the records equal page-at-a-time prediction's."""
    from kraken_tpu_torch.inference.recognition import recognition_stream
    im, _, seg = arabic
    small = im.resize((im.width // 2, im.height // 2))
    small_seg = dataclasses.replace(seg, lines=[
        dataclasses.replace(line, baseline=[[x // 2, y // 2] for x, y in line.baseline],
                            boundary=[[x // 2, y // 2] for x, y in line.boundary])
        for line in seg.lines[:5]])
    model = load_models(resources / 'overfit_bl_newpoly.safetensors')[0]
    model.prepare_for_inference(RecognitionInferenceConfig(
        num_line_workers=0, batch_size=4, padding=1, device='cpu', line_extraction='device'))
    pages = [(small, small_seg), (small.copy(), small_seg)]
    ref = [list(model.predict(p, s)) for p, s in pages]
    # every call reads its pages anew: count the stream's page buffers alone
    model._page_buf_cache.clear()
    out = list(recognition_stream(model, pages))
    for (_, _, records), expected in zip(out, ref):
        assert [r.prediction for r in records] == [r.prediction for r in expected]
        assert [r.cuts for r in records] == [r.cuts for r in expected]
        for a, b in zip(records, expected):
            np.testing.assert_allclose(a.confidences, b.confidences, atol=CONF_ATOL)
    assert len(model._page_buf_cache) == 2


# ------------------------------------------------------- byte transfers

@pytest.fixture(scope='module')
def five_lines(resources, line_im):
    return line_im, _both_segs(resources, LINE_ENDS)


@pytest.fixture(scope='module')
def transfer_runs(resources, five_lines):
    """The five lines of tests/test_rpred.py:201 through every route of
    both packages, batch 4 (multiple widths a batch, a ragged final batch,
    padded batch counts)."""
    im, segs = five_lines
    runs = {}
    for route in ({'input_transfer': 'float'}, {'input_transfer': 'uint8'},
                  {'input_transfer': 'packed'}, {'line_extraction': 'device'}):
        out = []
        for load, config, seg, tele in ((load_models, RecognitionInferenceConfig, segs[0],
                                         telemetry),
                                        (jax_load_models, JaxConfig, segs[1], jax_telemetry)):
            model = load(resources / 'overfit.mlmodel')[0]
            model.prepare_for_inference(config(batch_size=4, num_line_workers=0, padding=1,
                                               device='cpu', **route))
            with tele.collect() as stats:
                records = list(model.predict(im, seg))
            out.append((records, stats))
        runs[next(iter(route.values()))] = out
    return runs


def test_packed_equals_uint8_bit_for_bit(transfer_runs):
    (packed, stats_pk), _ = transfer_runs['packed']
    (u8, stats_u8), _ = transfer_runs['uint8']
    assert len(packed) == len(u8) == 5
    for a, b in zip(packed, u8):
        assert a.prediction == b.prediction
        assert a.cuts == b.cuts
        assert list(a.confidences) == list(b.confidences)
    assert stats_pk.up_bytes < stats_u8.up_bytes


@pytest.mark.parametrize('route', ['float', 'uint8', 'packed', 'device'])
def test_route_records_and_bytes_equal_jax(transfer_runs, route):
    """Records and uploaded bytes equal the JAX package's on every route.
    Downloads differ by the labels' width only: the port's tail writes
    int64 labels (torch's argmax type), JAX's argmax int32."""
    (ours, ts), (theirs, tj) = transfer_runs[route]
    _same_records(ours, theirs)
    assert (ts.up_bytes, ts.up_calls) == (tj.up_bytes, tj.up_calls)
    assert ts.down_calls == tj.down_calls
    assert ts.down_bytes > tj.down_bytes and (ts.down_bytes - tj.down_bytes) % 4 == 0


def test_transforms_uint8_equal_jax(resources):
    from kraken_tpu.dataset import ImageInputTransforms as JaxTransforms
    from kraken_tpu_torch.dataset import ImageInputTransforms
    line = Image.open(resources / '000236.png').crop((0, 0, 900, 156))
    ours = ImageInputTransforms(1, 30, 0, 1, (16, 0), False, dtype=np.uint8)(line)
    theirs = JaxTransforms(1, 30, 0, 1, (16, 0), False, dtype=np.uint8)(line)
    assert ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, theirs)


def test_segmentation_bytes_equal_jax(resources):
    """Telemetry of a segmentation page: the page uploaded and the heatmaps
    downloaded."""
    from kraken_tpu.configs import SegmentationInferenceConfig as JaxSegConfig
    from kraken_tpu_torch.configs import SegmentationInferenceConfig
    page = Image.open(resources / '170025120000003,0074.jpg').resize((354, 512))
    stats = []
    for load, config, tele in ((load_models, SegmentationInferenceConfig, telemetry),
                               (jax_load_models, JaxSegConfig, jax_telemetry)):
        model = load(resources / 'blla_small.safetensors')[0]
        model.prepare_for_inference(config(device='cpu'))
        with tele.collect() as s:
            model.predict(page)
        stats.append(s)
    assert stats[0].up_bytes == stats[1].up_bytes > 0
    assert stats[0].up_calls == stats[1].up_calls == 1
    assert stats[0].down_bytes > 0 and stats[0].down_calls == 1


def test_ocr_transfer_bytes_equals_jax(tmp_path, resources):
    import kraken_tpu.kraken as jax_kraken
    from kraken_tpu_torch import kraken as torch_kraken
    texts = []
    for cli in (jax_kraken, torch_kraken):
        out = tmp_path / f'{cli.__name__}.txt'
        with warnings.catch_warnings():
            warnings.simplefilter('ignore')
            result = CliRunner().invoke(cli.cli, [
                '-d', 'cpu', '-i', str(resources / '000236.png'), str(out), 'ocr', '-s',
                '-m', str(resources / 'overfit.mlmodel'), '--num-line-workers', '0',
                '--transfer', 'bytes'])
        assert result.exit_code == 0, (result.output, result.exception)
        texts.append(out.read_text(encoding='utf-8'))
    assert texts[1].strip() and texts[1] == texts[0]


def test_ocr_transfer_bytes_takes_the_packed_route(monkeypatch, tmp_path, resources):
    from kraken_tpu_torch import kraken as torch_kraken
    from kraken_tpu_torch.ops import extract
    seen = []
    real = extract.packed_gather

    def spy(*args, **kwargs):
        seen.append(args[0].shape)
        return real(*args, **kwargs)

    monkeypatch.setattr(extract, 'packed_gather', spy)
    result = CliRunner().invoke(torch_kraken.cli, [
        '-d', 'cpu', '-i', str(resources / '000236.png'), str(tmp_path / 'x.txt'), 'ocr', '-s',
        '-m', str(resources / 'overfit.mlmodel'), '--transfer', 'bytes'])
    assert result.exit_code == 0, result.output
    assert len(seen) == 1 and seen[0][0] == 1


def test_config_keys_and_predicate_equal_jax(resources):
    """The two keys keep the JAX defaults, and the route is chosen by the
    JAX package's predicate."""
    ours, theirs = RecognitionInferenceConfig(), JaxConfig()
    assert (ours.input_transfer, ours.line_extraction) == \
        (theirs.input_transfer, theirs.line_extraction) == ('float', 'host')
    model = load_models(resources / 'overfit.mlmodel')[0]
    jmodel = jax_load_models(resources / 'overfit.mlmodel')[0]
    for cfg in (dict(), dict(line_extraction='device'),
                dict(line_extraction='device', return_line_image=True)):
        for seg_type in ('baselines', 'bbox'):
            assert extraction.supports_device_extraction(
                model, RecognitionInferenceConfig(device='cpu', **cfg), seg_type) == \
                jax_extraction.supports_device_extraction(jmodel, JaxConfig(**cfg), seg_type)
