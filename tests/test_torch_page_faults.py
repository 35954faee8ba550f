"""
Two faults of the JAX package's recognition engine that the port repairs,
each held beside the JAX package's behaviour, which keeps the fault:

- **Page pixels cached by size.** The JAX package caches the page's
  grayscale conversion and its pixel array on the PIL image and reuses
  them whenever the size matches (kraken_tpu/inference/recognition.py:
  241-253, kraken_tpu/lib/geometry.py), so an image changed in place
  (``im.paste``) between two ``predict`` calls is recognised from its old
  pixels, on both line routes. The port reads the pixels anew in every
  call.
- **The device route's empty-line test.** The JAX device route calls a
  line empty when its axis-aligned strip is uniform
  (kraken_tpu/inference/recognition.py:293-296); the host route when the
  masked, dewarped line tensor is. A line whose polygon is blank but whose
  box takes in a neighbour's ink is empty on the host route and recognised
  on the device route. The port's device route judges the strip masked by
  the polygon and cropped as the host crops it
  (``inference/extraction.masked_blank``), so both routes give the empty
  record; a blank polygon whose mask leaves black corners in the crop is
  recognised on both routes, as before.

And one fault of the port's own: the page pipeline's prefetch threads
prepare the segmenter for every page, and two first calls that both moved
its network to the card at once, while one of them already ran its forward,
left some biases wrong on the card (``chip_smoke.py`` phase 25 segmented
the fixture page into 49-113 lines in some runs). ``prepare_segmentation``
now runs one thread at a time.
"""
import tests.test_torch_threads  # noqa: F401  (first: the thread share under xdist)
import threading
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

RESOURCES = Path(__file__).resolve().parent / 'resources'
MODEL = RESOURCES / 'overfit.mlmodel'
ROUTES = ('host', 'device')


@pytest.fixture(scope='module', autouse=True)
def quiet():
    warnings.filterwarnings('ignore', category=DeprecationWarning)
    warnings.filterwarnings('ignore', category=UserWarning)


def _models():
    """The port's and the JAX package's recognizer."""
    from kraken_tpu.models import load_models as jax_load_models
    from kraken_tpu_torch.models import load_models
    return {'port': load_models(MODEL)[0], 'jax': jax_load_models(MODEL)[0]}


def _seg(package: str, lines: list):
    """A baseline Segmentation of (baseline, boundary) pairs in one package."""
    if package == 'jax':
        from kraken_tpu.containers import BaselineLine, Segmentation
    else:
        from kraken_tpu_torch.containers import BaselineLine, Segmentation
    return Segmentation(type='baselines', imagename='page', text_direction='horizontal-lr',
                        script_detection=False,
                        lines=[BaselineLine(id=f'l{i}', baseline=bl, boundary=pl)
                               for i, (bl, pl) in enumerate(lines)])


def _predict(model, package: str, route: str, im, seg) -> list:
    if package == 'jax':
        from kraken_tpu.configs import RecognitionInferenceConfig
        kwargs = {'precision': '32-true'}
    else:
        from kraken_tpu_torch.configs import RecognitionInferenceConfig
        kwargs = {'device': 'cpu'}
    model.prepare_for_inference(RecognitionInferenceConfig(
        **kwargs, num_line_workers=0, padding=1, batch_size=3, line_extraction=route))
    return [r.prediction for r in model.predict(im, seg)]


@pytest.fixture(scope='module')
def models():
    return _models()


# three lines of the fixture line image, as tests/test_parallel.py:113-140
PAGE_LINES = [([[0, 10], [x1, 10]], [[0, 0], [x1, 0], [x1, 155], [0, 155]])
              for x1 in (2543, 1800, 1200)]


@pytest.mark.parametrize('mode', ['L', 'RGB'])
@pytest.mark.parametrize('route', ROUTES)
def test_image_changed_in_place_is_read_anew(models, route, mode):
    """A blank page recognised, then the fixture's pixels pasted into it:
    the port's second call reads the new pixels (the records of a fresh
    copy), the JAX package's the old ones."""
    page = Image.open(RESOURCES / '000236.png').convert(mode)
    out = {}
    for package, model in models.items():
        seg = _seg(package, PAGE_LINES)
        im = Image.new(mode, page.size, 'white')
        first = _predict(model, package, route, im, seg)
        im.paste(page)
        out[package] = (first, _predict(model, package, route, im, seg),
                        _predict(model, package, route, page.copy(), seg))
    first, second, fresh = out['port']
    assert first == [''] * 3
    assert all(fresh) and second == fresh
    jax_first, jax_second, jax_fresh = out['jax']
    assert jax_fresh == fresh
    assert jax_second == jax_first == [''] * 3  # the reference's fault


def _blank_page() -> Image.Image:
    """A white page with a neighbour's ink right above the line."""
    page = np.full((160, 420), 255, np.uint8)
    page[30:60, 20:120] = 0
    return Image.fromarray(page, 'L')


BASELINE = [[20, 80], [380, 80]]
# a blank rectangle under the ink, its outline running up the left edge
# through the ink and back: the box takes in the ink, the mask only a
# column of it, which the host's content crop drops
SPIKE = [[20, 60], [380, 60], [380, 85], [20, 85], [20, 60], [20, 40]]
# a blank pentagon whose box takes in the ink: the mask leaves black
# corners in the crop, so the host route recognises it
PENTAGON = [[20, 60], [200, 40], [380, 60], [380, 85], [20, 85]]


def test_blank_polygon_line_is_empty_on_both_routes(models):
    out = {(package, route): _predict(model, package, route, _blank_page(),
                                      _seg(package, [(BASELINE, SPIKE)]))
           for package, model in models.items() for route in ROUTES}
    assert out['port', 'host'] == out['port', 'device'] == ['']
    assert out['jax', 'host'] == ['']
    assert out['jax', 'device'] != ['']  # the reference's fault


def test_blank_polygon_with_black_corners_is_recognised_on_both_routes(models):
    port = models['port']
    for route in ROUTES:
        assert _predict(port, 'port', route, _blank_page(),
                        _seg('port', [(BASELINE, PENTAGON)])) != ['']


@pytest.mark.parametrize('padded, want', [(True, False), (False, True)])
def test_masked_blank_needs_white_with_side_padding(padded, want):
    """A uniform grey crop is a line tensor of one value only without the
    white side padding."""
    from kraken_tpu_torch.inference.extraction import masked_blank
    strip = np.full((30, 50), 200, np.uint8)
    assert masked_blank(strip, [[5, 0], [54, 0], [54, 29], [5, 29]], padded) is want
    assert masked_blank(np.zeros((30, 50), np.uint8), [[0, 0], [49, 0], [49, 29]]) is False


def test_concurrent_prepares_move_the_network_one_at_a_time():
    """Four threads prepare one segmenter at once (as the page pipeline's
    prefetch threads do for every page): no two of them are inside the
    network's move at the same time."""
    from kraken_tpu_torch.configs import SegmentationInferenceConfig
    from kraken_tpu_torch.models import load_models
    model = load_models(RESOURCES / 'blla_small.safetensors')[0]
    real, inside, seen = model.net.to, [0], []

    def slow_to(*args, **kwargs):
        inside[0] += 1
        seen.append(inside[0])
        time.sleep(0.05)
        try:
            return real(*args, **kwargs)
        finally:
            inside[0] -= 1
    model.net.to = slow_to
    threads = [threading.Thread(target=model.prepare_for_inference,
                                args=(SegmentationInferenceConfig(device='cpu'),))
               for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert seen == [1, 1, 1, 1]
