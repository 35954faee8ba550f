"""
The port's legacy box segmenter (kraken_tpu_torch.pageseg), its host nlbin
(kraken_tpu_torch.binarization) and the native helpers under them, against
the JAX package's: tests/test_pageseg.py ported whole, each case holding
the port to the JAX function on the same input as well.

- ``pageseg.segment``: the same Segmentation (type, direction, image name
  and every line's box, in order) as the JAX segmenter, on ``bw.png`` and
  ``input_bw.png``, with black column separators, padding and a mask, in
  every text direction and on a vertical page;
- the host ``nlbin``: the same bytes as the JAX one on ``input.jpg``, a
  crop and the whole of the fixture page;
- ``line_seeds_native``, ``label4_native``, ``find_objects_native`` and
  ``sliding_percentile_native``, loaded from the port's own
  ``_build/_native.so``, against the Python loop, scipy and numpy they
  replace;
- the legacy page's text: ``bw.png`` through the port's segmenter and
  recognizer on the CPU in fp32 equals ``bw_page_golden.json``.
"""
import tests.test_torch_threads  # noqa: F401  (first: the thread share under xdist)
import json

import numpy as np
import pytest
from PIL import Image

from kraken_tpu import pageseg as jax_pageseg
from kraken_tpu.binarization import nlbin as jax_nlbin
from kraken_tpu_torch import native
from kraken_tpu_torch.binarization import nlbin
from kraken_tpu_torch.exceptions import KrakenInputException
from kraken_tpu_torch.pageseg import segment


def same_segmentation(port, jax) -> None:
    assert (port.type, port.text_direction, port.imagename, port.script_detection) == \
        (jax.type, jax.text_direction, jax.imagename, jax.script_detection)
    assert port.regions == jax.regions and port.line_orders == jax.line_orders
    assert [line.bbox for line in port.lines] == [line.bbox for line in jax.lines]


def both(im, **kwargs):
    """The port's Segmentation, held to the JAX one on the same input."""
    seg = segment(im, **kwargs)
    same_segmentation(seg, jax_pageseg.segment(im, **kwargs))
    return seg


def test_segment_color_rejected(resources):
    with pytest.raises(KrakenInputException):
        with Image.open(resources / 'input.jpg') as im:
            segment(im)


def test_segment_bw(resources):
    with Image.open(resources / 'bw.png') as im:
        seg = both(im)
        assert seg.type == 'bbox'
        assert seg.imagename == im.filename
        assert abs(len(seg.lines) - 30) <= 5
        for line in seg.lines:
            x0, y0, x1, y1 = line.bbox
            assert 0 < x0 and 0 < y0
            assert x1 < im.size[0] and y1 < im.size[1]


def test_segment_black_colseps(resources):
    with Image.open(resources / 'bw.png') as im:
        seg = both(im, black_colseps=True)
        assert seg.type == 'bbox'
        assert len(seg.lines) > 10


def test_segment_vertical(resources):
    with Image.open(resources / 'bw.png') as im:
        seg = both(im, text_direction='vertical-lr')
        assert seg.type == 'bbox'


@pytest.mark.parametrize('direction', ['horizontal-lr', 'horizontal-rl', 'vertical-lr',
                                       'vertical-rl'])
def test_segment_text_directions(resources, direction):
    """Every text direction gives a structurally valid segmentation, the
    JAX one."""
    im = Image.open(resources / 'bw.png')
    seg = both(im, text_direction=direction)
    assert seg.type == 'bbox'
    assert len(seg.lines) > 0
    for line in seg.lines:
        x0, y0, x1, y1 = line.bbox
        assert 0 <= x0 <= x1 <= im.width
        assert 0 <= y0 <= y1 <= im.height


@pytest.mark.parametrize('kwargs', [{}, {'black_colseps': True, 'maxcolseps': 0},
                                    {'pad': (3, 9), 'no_hlines': False}, {'scale': 12.0}],
                         ids=['default', 'black_colseps', 'pad_hlines', 'scale'])
def test_segment_input_bw_equals_jax(resources, kwargs):
    with Image.open(resources / 'input_bw.png') as im:
        assert len(both(im, **kwargs).lines) > 10


def test_segment_vertical_page_equals_jax(resources):
    """A page of vertical lines (``bw.png`` turned a quarter) segmented
    with the vertical text directions."""
    with Image.open(resources / 'bw.png') as im:
        page = im.transpose(Image.Transpose.ROTATE_90)
    for direction in ('vertical-lr', 'vertical-rl'):
        assert len(both(page, text_direction=direction).lines) > 10


def test_segment_mask_equals_jax(resources):
    with Image.open(resources / 'bw.png') as im:
        mask = Image.new('1', im.size, 0)
        mask.paste(1, (0, 0, im.width, 40))
        both(im, mask=mask)


def test_nlbin_color(resources):
    with Image.open(resources / 'input.jpg') as im:
        out = nlbin(im)
        assert out.mode in ('1', 'L')
        colors = out.getcolors(2)
        assert colors is not None and len(colors) <= 2
        assert out.tobytes() == jax_nlbin(im).tobytes()


def test_nlbin_bitonal_passthrough(resources):
    with Image.open(resources / 'bw.png') as im:
        out = nlbin(im)
        assert out is im


def test_nlbin_empty():
    im = Image.new('L', (100, 100), 128)
    with pytest.raises(KrakenInputException):
        nlbin(im)


def test_nlbin_fft_path_no_nan(resources):
    """The FFT gaussian pass can ring a few ULPs below zero on the squared
    residual; nlbin must clamp before the sqrt (a crop of the fixture
    page), as the JAX nlbin does, to the same bytes."""
    im = Image.open(resources / '170025120000003,0074.jpg').convert('L')
    im = im.crop((0, 0, 900, 700))
    bw = nlbin(im)
    assert bw.mode in ('1', 'L')
    vals = np.unique(np.asarray(bw.convert('L')))
    assert set(vals.tolist()) <= {0, 255}
    assert bw.size == im.size
    assert bw.tobytes() == jax_nlbin(im).tobytes()


def test_nlbin_fixture_page_equals_jax(resources):
    with Image.open(resources / '170025120000003,0074.jpg') as im:
        port = nlbin(im)
        assert (port.mode, port.size) == (jax_nlbin(im).mode, im.size)
        assert port.tobytes() == jax_nlbin(im).tobytes()


def test_native_helpers_load_from_the_ports_library():
    """The helpers of the legacy path come from the port's own
    ``_build/_native.so``, built from the port's sources."""
    from pathlib import Path
    lib = native._load()
    assert lib is not None
    assert Path(lib._name).resolve() == (native.BUILD_DIR / '_native.so').resolve()
    for symbol in ('line_seeds', 'sliding_percentile_f64', 'label4_u8', 'find_objects_i32'):
        assert hasattr(lib, symbol)


def test_line_seeds_native_parity():
    """C++ line-seed marking is bit-identical to the per-column python
    loop (including the empty fill when a baseline mark sits closer than
    delta to the top edge)."""
    assert native.available()
    rng = np.random.RandomState(42)
    for _ in range(5):
        h, w = rng.randint(30, 80), rng.randint(30, 80)
        bmarked = rng.rand(h, w) < 0.05
        tmarked = rng.rand(h, w) < 0.05
        scale = rng.uniform(2, 12)
        delta = max(3, int(scale / 2))
        ref = np.zeros((h, w), 'i')
        for x in range(w):
            transitions = sorted([(y, 1) for y in np.nonzero(bmarked[:, x])[0]] +
                                 [(y, 0) for y in np.nonzero(tmarked[:, x])[0]])[::-1]
            transitions.append((0, 0))
            for ls in range(len(transitions) - 1):
                y0, s0 = transitions[ls]
                if s0 == 0:
                    continue
                ref[y0 - delta:y0, x] = 1
                y1, s1 = transitions[ls + 1]
                if s1 == 0 and (y0 - y1) < 5 * scale:
                    ref[y1:y0, x] = 1
        out = native.line_seeds_native(bmarked, tmarked, delta, 5 * scale)
        np.testing.assert_array_equal(out, ref)


def test_native_label_find_objects_match_scipy():
    """The native 4-connectivity CCL and bbox scan (native/morphology.cpp)
    reproduce scipy.ndimage.label (default structure, including the
    raster-first-encounter label numbering) and find_objects exactly."""
    from scipy import ndimage
    assert native.available()
    rng = np.random.RandomState(11)
    for _ in range(12):
        h, w = rng.randint(2, 250), rng.randint(2, 250)
        img = rng.rand(h, w) < rng.uniform(0.2, 0.8)
        lab_n, n_n = native.label4_native(img)
        lab_s, n_s = ndimage.label(img)
        assert n_n == n_s
        assert np.array_equal(lab_n, lab_s)
        assert native.find_objects_native(lab_n) == ndimage.find_objects(lab_s)
        # absent labels emit None, max_label is honored
        holes = lab_s.copy()
        if n_s:
            holes[holes == 1] = 0
        assert native.find_objects_native(holes, n_s) == ndimage.find_objects(holes, n_s)


@pytest.mark.parametrize('window', [(20, 2), (2, 20), (7, 3), (1, 1), (30, 2)])
def test_sliding_percentile_native_equals_numpy(window):
    """The native sliding percentile (symmetric padding, np.percentile's
    lerp) equals the numpy window stack bit for bit, maps narrower than the
    window included."""
    from numpy.lib.stride_tricks import sliding_window_view
    assert native.available()
    rng = np.random.RandomState(3)
    for h, w in [(40, 33), (5, 60), (13, 1)]:
        arr = rng.rand(h, w)
        arr[0, :2] = arr[1, 0]  # ties
        wh, ww = window
        top, left = (wh - 1) // 2, (ww - 1) // 2
        padded = np.pad(arr, ((top, wh - 1 - top), (left, ww - 1 - left)), mode='symmetric')
        ref = np.percentile(sliding_window_view(padded, window), 80, axis=(-2, -1))
        out = native.sliding_percentile_native(arr, 80, window)
        assert out is not None and np.array_equal(out, ref)


def test_legacy_page_text_equals_the_golden(resources):
    """``bw.png`` through the port's legacy segmenter and the overfit
    recognizer on the CPU in fp32: the pinned page transcription."""
    from kraken_tpu_torch.configs import RecognitionInferenceConfig
    from kraken_tpu_torch.models import load_models
    golden = json.loads((resources / 'bw_page_golden.json').read_text(encoding='utf-8'))
    im = Image.open(resources / 'bw.png')
    model = load_models(resources / 'overfit.mlmodel')[0]
    model.prepare_for_inference(RecognitionInferenceConfig(device='cpu', batch_size=32,
                                                           num_line_workers=0))
    texts = {str(i): r.prediction for i, r in enumerate(model.predict(im, segment(im)))}
    assert texts == golden
