"""
The un-fused ridge route of the port (``SegmentationInferenceConfig(
fused_ridge=False)``) against the JAX package on the CPU:

- the port's host ``lib/vectorization.sato_ridge`` and the plain version of
  ``ops/ridge.sato_ridge_device`` (``device='cpu'``) hold the JAX
  package's ``sato_ridge`` and ``sato_ridge_device`` within 1e-5 (the
  contract of tests/test_ops.py:122-131), with ``black_ridges`` both ways;
- on the fixture page the un-fused route gives the fused route's
  Segmentation (tests/test_segmentation.py:247-271) and the JAX package's
  un-fused one, with the host filter and with ``device_vectorize`` (the
  response mode's plain version here); with uint8 heatmaps the filter reads
  the quantized maps, in both packages alike;
- 'packbits' falls back to 'uint8' without the fused ridge, as in the JAX
  package, and the route thresholds at ``vectorize_lines``' 0.17 whatever
  ``ridge_threshold`` says (the JAX package passes no threshold there).

The response mode of ``csrc/ridge.cu`` itself runs only on the card (the
``cuda`` test below, which imports no JAX: ``python -m pytest
tests/test_torch_ridge_unfused.py -m cuda --noconftest`` there;
``chip_smoke.py --ridge-unfused``).
"""
import test_torch_threads  # noqa: F401  (first: the thread share under xdist)
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

RESOURCES = Path(__file__).resolve().parent / 'resources'
PAGE = RESOURCES / '170025120000003,0074.jpg'
MODEL = RESOURCES / 'blla_small.safetensors'
ATOL = 1e-5


def _ridge_maps() -> list:
    """A blurred line (tests/test_ops.py:122-131), random heatmaps and maps
    narrower than the largest radius."""
    from scipy.ndimage import gaussian_filter
    bl = np.zeros((64, 96), np.float32)
    bl[30, 10:86] = 1.0
    rng = np.random.RandomState(0)
    return [np.clip(gaussian_filter(bl, 2) * 6, 0, 1),
            (1 / (1 + np.exp(-4 * rng.randn(45, 77)))).astype(np.float32),
            rng.rand(7, 130).astype(np.float32), rng.rand(1, 1).astype(np.float32)]


@pytest.mark.parametrize('black', [False, True])
@pytest.mark.parametrize('case', range(4))
def test_host_sato_ridge_equals_jax(case, black):
    from kraken_tpu.lib.vectorization import sato_ridge as jax_sato
    from kraken_tpu_torch.lib.vectorization import sato_ridge
    im = _ridge_maps()[case]
    got = sato_ridge(im, black_ridges=black)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, jax_sato(im, black_ridges=black), atol=ATOL)


@pytest.mark.parametrize('black', [False, True])
@pytest.mark.parametrize('case', range(4))
def test_sato_ridge_device_equals_jax(case, black):
    """The plain version on the CPU against the JAX device filter and the
    port's host filter, within 1e-5."""
    from kraken_tpu.ops.ridge import sato_ridge_device as jax_device
    from kraken_tpu_torch.lib.vectorization import sato_ridge
    from kraken_tpu_torch.ops.ridge import sato_ridge_device
    im = _ridge_maps()[case]
    got = sato_ridge_device(im, black_ridges=black, device='cpu')
    assert got.dtype == np.float32 and got.shape == im.shape
    np.testing.assert_allclose(got, jax_device(im, black_ridges=black), atol=ATOL)
    np.testing.assert_allclose(got, sato_ridge(im, black_ridges=black), atol=ATOL)


def test_sato_ridge_device_sigmas():
    """The plain version takes any sigmas (as the JAX function); the
    kernel's taps are fixed at the five defaults, so CUDA refuses others
    before it touches the card."""
    from kraken_tpu.ops.ridge import sato_ridge_device as jax_device
    from kraken_tpu_torch.ops.ridge import sato_ridge_device
    im = _ridge_maps()[1]
    np.testing.assert_allclose(sato_ridge_device(im, sigmas=(1, 2), device='cpu'),
                               jax_device(im, sigmas=(1, 2)), atol=ATOL)
    with pytest.raises(ValueError, match='sigmas'):
        sato_ridge_device(im, sigmas=(1, 2), device='cuda')
    with pytest.raises(ValueError, match=r'one \(H, W\) map'):
        sato_ridge_device(np.zeros((2, 3, 4), np.float32), device='cpu')


# each route as SegmentationInferenceConfig keywords (the same in both packages)
ROUTES = {'fused': {},
          'unfused': {'fused_ridge': False},
          'unfused_device_vectorize': {'fused_ridge': False, 'device_vectorize': True},
          'unfused_uint8': {'fused_ridge': False, 'heatmap_precision': 'uint8'},
          'unfused_packbits': {'fused_ridge': False, 'heatmap_precision': 'packbits'},
          'unfused_threshold_0.5': {'fused_ridge': False, 'ridge_threshold': 0.5},
          'fused_threshold_0.5': {'ridge_threshold': 0.5}}
JAX_ROUTES = ('unfused', 'unfused_uint8', 'unfused_packbits', 'unfused_threshold_0.5')


def _run(package: str, routes) -> dict:
    """(Segmentation record, the transfer the route took) of each route on
    the fixture page in one package."""
    from tests.test_torch_segmentation import seg_record
    if package == 'jax':
        from kraken_tpu.configs import SegmentationInferenceConfig as Config
        from kraken_tpu.models import load_models
        kwargs = {'precision': '32-true'}
    else:
        from kraken_tpu_torch.configs import SegmentationInferenceConfig as Config
        from kraken_tpu_torch.models import load_models
        kwargs = {'device': 'cpu'}
    im = Image.open(PAGE)
    model = load_models(MODEL)[0]
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        for route in routes:
            model.prepare_for_inference(Config(**kwargs, **ROUTES[route]))
            out[route] = (seg_record(model.predict(im)), model._seg_transfer)
    return out


@pytest.fixture(scope='module')
def routes():
    return {'port': _run('port', ROUTES), 'jax': _run('jax', JAX_ROUTES)}


@pytest.mark.parametrize('route', ['unfused', 'unfused_device_vectorize'])
def test_unfused_equals_fused_and_jax(routes, route):
    port = routes['port']
    assert len(port[route][0]['lines']) == 46
    assert port[route][0] == port['fused'][0]
    assert port[route][0] == routes['jax']['unfused'][0]


def test_unfused_uint8_equals_jax(routes):
    """The host filter reads the dequantized bytes: the lines move against
    the float route, as in the JAX package."""
    got, want = routes['port']['unfused_uint8'], routes['jax']['unfused_uint8']
    assert got == want == (got[0], 'uint8')
    assert len(got[0]['lines']) == 46


def test_packbits_falls_back_to_uint8(routes):
    """The packed masks need the fused ridge: without it 'packbits' takes
    'uint8', in both packages."""
    assert routes['port']['unfused_packbits'] == routes['jax']['unfused_packbits']
    assert routes['port']['unfused_packbits'] == routes['port']['unfused_uint8']


def test_ridge_threshold_ignored_unfused(routes):
    """``ridge_threshold`` moves the fused route's lines but not the
    un-fused route's, which thresholds at 0.17 as the JAX package does."""
    port = routes['port']
    assert port['fused_threshold_0.5'][0] != port['fused'][0]
    assert port['unfused_threshold_0.5'] == port['unfused']
    assert port['unfused_threshold_0.5'][0] == routes['jax']['unfused_threshold_0.5'][0]


def test_unfused_forward_launches_no_ridge():
    """With ``fused_ridge=False`` the forward filters no channel and sends
    back the heatmaps alone."""
    from kraken_tpu_torch.configs import SegmentationInferenceConfig
    from kraken_tpu_torch.inference.segmentation import _seg_forward
    from kraken_tpu_torch.models import load_models
    model = load_models(MODEL)[0]
    model.prepare_for_inference(SegmentationInferenceConfig(device='cpu', fused_ridge=False))
    assert model._seg_fused_channels == ()
    heat, bins = _seg_forward(model, torch.zeros(1, 3, 64, 48), 64, 48)
    assert bins is None and heat.dtype == torch.float32


@pytest.mark.cuda
@pytest.mark.parametrize('shape', [(512, 354), (45, 77), (7, 130), (1, 1), (40, 127)])
@pytest.mark.parametrize('black', [False, True])
def test_response_mode_matches_plain(shape, black):
    """The kernel's response mode against its plain version on the card,
    one launch counted, no mask written."""
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernel has no CPU mode')
    from kraken_tpu_torch.ops.ridge import sato_ridge_device, sato_ridge_threshold
    im = np.random.RandomState(sum(shape)).rand(*shape).astype(np.float32)
    before = (sato_ridge_device.launches, sato_ridge_threshold.launches)
    got = sato_ridge_device(im, black_ridges=black, device='cuda')
    assert (sato_ridge_device.launches, sato_ridge_threshold.launches) == \
        (before[0] + 1, before[1])
    want = sato_ridge_device(im, black_ridges=black, device='cpu')
    np.testing.assert_allclose(got, want, atol=ATOL)
