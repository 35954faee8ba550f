"""
Segmentation's device options in the port (``heatmap_precision``
'uint8'/'packbits'/'auto', ``input_transfer='uint8'``, ``device_vectorize``,
``width_bucketing``) against the JAX package on the CPU:

- the plain versions of the four kernels (``ops/segmask.py``,
  ``ops/seam.py``) equal the JAX functions bit for bit: ``_maxpool20``
  (with scipy's ``maximum_filter``, maps under the 10-pixel pad too),
  ``_packbits_w``, the whole packbits tail of the JAX forward on the same
  heatmaps and ridge masks, the quantization at the exact halves,
  ``_seam_forward_batch``'s backtrack and the cost column the start
  selection reads, and ``carve_seams_device``'s rows (also against the
  native host DP, except where the sums overflow);
- on the shipped model and the fixture page each route's Segmentation,
  and the bytes it sends up and down (``lib/telemetry.py``), equal the
  JAX package's same route; a two-page ``packbits`` batch too;
- ``polygonize_page`` and ``calculate_polygonal_environment`` with the
  device carver (its plain version here) equal the host carver and the
  JAX package's, also when every line fails and on the
  ``raise_on_error=True`` path.

The kernels themselves run only on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py --seg-routes``).
"""
import tests.test_torch_threads  # noqa: F401  (first: the thread share under xdist)
import warnings
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from tests.test_torch_segmentation import NARROW_SPEC, seg_record

RESOURCES = Path(__file__).resolve().parent / 'resources'
PAGE = RESOURCES / '170025120000003,0074.jpg'
MODEL = RESOURCES / 'blla_small.safetensors'
# each route as SegmentationInferenceConfig keywords (the same in both packages)
ROUTES = {'float': {},
          'uint8_input': {'input_transfer': 'uint8'},
          'uint8_heatmaps': {'heatmap_precision': 'uint8'},
          'packbits': {'heatmap_precision': 'packbits'},
          'auto': {'heatmap_precision': 'auto'},
          'device_vectorize': {'device_vectorize': True},
          'width_bucketing': {'width_bucketing': True},
          'bytes_cli': {'input_transfer': 'uint8', 'heatmap_precision': 'auto',
                        'device_vectorize': True}}


def rand_maps(shape, seed: int) -> np.ndarray:
    """Sigmoids of random logits, float32 (many pixels near 0 and 1)."""
    rng = np.random.RandomState(seed)
    return (1 / (1 + np.exp(-4 * rng.randn(*shape)))).astype(np.float32)


@pytest.mark.parametrize('shape', [(1, 1, 3), (1, 5, 7), (2, 9, 10), (1, 1, 1), (3, 40, 77),
                                   (2, 512, 354)])
def test_maxpool20_equals_jax_and_scipy(shape):
    from scipy.ndimage import maximum_filter
    from kraken_tpu.inference.segmentation import _maxpool20
    from kraken_tpu_torch.ops.segmask import maxpool20
    x = rand_maps(shape, sum(shape))
    got = maxpool20(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.jit(_maxpool20)(jnp.asarray(x))))
    np.testing.assert_array_equal(got, np.stack([maximum_filter(m, size=20, mode='reflect')
                                                 for m in x]))


@pytest.mark.parametrize('width', [1, 7, 8, 9, 354])
def test_packbits_equals_jax(width):
    from kraken_tpu.inference.segmentation import _packbits_w
    from kraken_tpu_torch.ops.segmask import packbits_reference
    m = np.random.RandomState(width).rand(2, 3, 5, width) > 0.5
    got = packbits_reference(torch.from_numpy(m)).numpy()
    assert got.shape == (2, 3, 5, -(-width // 8)) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, np.asarray(jax.jit(_packbits_w)(jnp.asarray(m))))
    np.testing.assert_array_equal(np.unpackbits(got, axis=-1)[..., :width].astype(bool), m)


def _jax_packbits_tail(probs, regions, st, end, ridge):
    """The packbits tail of the JAX forward (inference/segmentation.py:
    173-185) on given heatmaps and ridge masks, jitted as there."""
    from kraken_tpu.inference.segmentation import _maxpool20, _packbits_w

    def tail(probs, ridge):
        masks = [probs[:, c] > 0.5 for c in regions]
        diff = _maxpool20(probs[:, st]) - _maxpool20(probs[:, end])
        masks += [diff > 0.2, diff < -0.2]
        masks += [ridge[:, j] for j in range(ridge.shape[1])]
        return _packbits_w(jnp.stack(masks, 1))
    return np.asarray(jax.jit(tail)(jnp.asarray(probs), jnp.asarray(ridge)))


@pytest.mark.parametrize('shape', [(1, 10, 512, 354), (2, 10, 37, 45)])
def test_pack_masks_equals_the_jax_packbits_tail(shape):
    """Ties at exactly 0.5 and separator maps whose max-filtered difference
    lands on ±0.2 included."""
    from kraken_tpu_torch.ops.segmask import maxpool20, pack_masks
    probs = rand_maps(shape, 3)
    probs[:, :, ::3, ::2] = 0.5
    probs[:, 0, ::4] = np.float32(0.7)
    probs[:, 1, ::4] = np.float32(0.5)
    ridge = rand_maps((shape[0], 4) + shape[2:], 4) > 0.5
    regions = (6, 7, 8, 9)
    want = _jax_packbits_tail(probs, regions, 0, 1, ridge)
    t = torch.from_numpy(probs)
    filt = maxpool20(t[:, [0, 1]].reshape(-1, *shape[2:])).reshape(shape[0], 2, *shape[2:])
    got = pack_masks(t, regions, filt, torch.from_numpy(ridge.astype(np.uint8)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('nr', [66, 70])
def test_pack_masks_takes_any_number_of_region_channels(nr):
    """A model with more than 64 region classes: the JAX packbits tail
    packs every one of them, and so does the port (it refused more than 64
    before)."""
    from kraken_tpu_torch.ops.segmask import maxpool20, pack_masks
    shape = (2, nr + 2, 23, 45)
    probs = rand_maps(shape, nr)
    probs[:, :, ::3, ::2] = 0.5
    ridge = rand_maps((2, 4) + shape[2:], nr + 1) > 0.5
    regions = tuple(range(2, nr + 2))
    want = _jax_packbits_tail(probs, regions, 0, 1, ridge)
    t = torch.from_numpy(probs)
    filt = maxpool20(t[:, [0, 1]].reshape(-1, *shape[2:])).reshape(2, 2, *shape[2:])
    got = pack_masks(t, regions, filt, torch.from_numpy(ridge.astype(np.uint8)))
    assert got.shape == (2, nr + 2 + 4, 23, 6)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('bad', [-1, 72, 1000])
def test_pack_masks_checks_each_channel_not_their_number(bad):
    """70 region channels of 72, in any order and repeated, are taken; one
    outside 0..71 among them raises and names it."""
    from kraken_tpu_torch.ops.segmask import pack_masks, pack_masks_reference
    probs = torch.from_numpy(rand_maps((1, 72, 5, 9), 6))
    filt = torch.from_numpy(rand_maps((1, 2, 5, 9), 7))
    ridge = torch.zeros((1, 1, 5, 9), dtype=torch.uint8)
    regions = [71, 3, 3] + list(range(4, 71))
    assert len(regions) == 70
    got = pack_masks(probs, regions, filt, ridge)
    assert got.shape == (1, 73, 5, 2)
    assert torch.equal(got, pack_masks_reference(probs, regions, filt, ridge))
    with pytest.raises(ValueError, match=rf'region channels \[{bad}\] do not lie in 0\.\.71'):
        pack_masks(probs, regions[:-1] + [bad], filt, ridge)


def test_quantize_u8_equals_jax_at_the_exact_halves():
    from kraken_tpu_torch.ops.segmask import quantize_u8
    halves = ((np.arange(255) + 0.5) / 255).astype(np.float32)
    p = np.concatenate([halves, [0.0, 1.0], rand_maps((1001,), 5)]).astype(np.float32)
    want = np.asarray(jax.jit(lambda x: jnp.round(x * 255).astype(jnp.uint8))(jnp.asarray(p)))
    got = quantize_u8(torch.from_numpy(p)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got.dtype == np.uint8 and (got[:255] % 2 == 0).all()  # half to even


def _seam_cases():
    """(tag, raw patches, whether the native host DP takes the same path):
    the cases of tests/test_ops.py:134-156 (random, tie-heavy), sums that
    overflow to inf (there the JAX device DP and the native host DP part),
    width-1 patches beside wide ones, a masked (+inf) last column."""
    rng = np.random.RandomState(0)
    raw = [rng.rand(h, w).astype(np.float32) for h, w in ((40, 120), (17, 60), (64, 200))]
    raw[1] = np.round(raw[1] * 4) / 4
    masked = rng.rand(20, 40).astype(np.float32)
    masked[:, -1] = np.inf
    masked[3:6] = np.inf
    return [('test_ops', raw, True),
            ('overflow', [rng.rand(12, 30).astype(np.float32) * np.float32(3.4e38),
                          rng.rand(12, 30).astype(np.float32)], False),
            ('width_1', [rng.rand(15, 1).astype(np.float32), rng.rand(15, 40).astype(np.float32),
                         rng.rand(7, 1).astype(np.float32)], True),
            ('masked_last_column', [masked, np.zeros((9, 33), np.float32)], True)]


def _padded(patches):
    padded = [np.pad(p, ((1, 1), (0, 0)), constant_values=np.inf) for p in patches]
    batch = np.full((len(padded), max(p.shape[0] for p in padded),
                     max(p.shape[1] for p in padded)), np.inf, np.float32)
    for i, p in enumerate(padded):
        batch[i, :p.shape[0], :p.shape[1]] = p
    return batch, np.array([p.shape[1] for p in padded], np.int32)


@pytest.mark.parametrize('tag, patches, host_dp', _seam_cases(), ids=[c[0] for c in _seam_cases()])
def test_seam_forward_equals_jax(tag, patches, host_dp):
    from kraken_tpu.ops.seam import _seam_forward_batch
    from kraken_tpu_torch.ops.seam import BIG, seam_forward
    batch, widths = _padded(patches)
    x = np.nan_to_num(batch, posinf=BIG)
    back_j, costs_j = map(np.asarray, _seam_forward_batch(jnp.asarray(x)))
    back, col = seam_forward(torch.from_numpy(x), torch.from_numpy(widths))
    np.testing.assert_array_equal(back.numpy(), back_j)
    np.testing.assert_array_equal(col.numpy(),
                                  costs_j[np.arange(len(widths)), np.maximum(widths - 2, 0)])


@pytest.mark.parametrize('tag, patches, host_dp', _seam_cases(), ids=[c[0] for c in _seam_cases()])
def test_carve_seams_device_equals_jax(tag, patches, host_dp):
    from kraken_tpu.ops.seam import carve_seams_device as jax_carve
    from kraken_tpu_torch.lib.polygonization import _carve_rows_device, _carve_seam
    from kraken_tpu_torch.ops.seam import carve_seams_device
    batch, widths = _padded(patches)
    rows = carve_seams_device(batch, widths, 'cpu')
    np.testing.assert_array_equal(rows, jax_carve(batch, widths))
    carved = _carve_rows_device(patches, 'cpu')
    for k, p in enumerate(patches):
        np.testing.assert_array_equal(carved[k], rows[k, :widths[k]] - 1)
        if host_dp:
            np.testing.assert_array_equal(carved[k], _carve_seam(p))


def test_carve_seams_device_refuses_bad_widths():
    from kraken_tpu_torch.ops.seam import carve_seams_device
    with pytest.raises(ValueError, match='widths'):
        carve_seams_device(np.zeros((2, 5, 4), np.float32), [4, 5], 'cpu')
    assert carve_seams_device(np.zeros((0, 5, 4), np.float32), None, 'cpu').shape == (0, 4)


def _run_routes(package: str) -> dict:
    """Each route of ROUTES on the fixture page in one package: (Segmentation
    record, bytes up, bytes down, the transfer the route took)."""
    if package == 'jax':
        from kraken_tpu.configs import SegmentationInferenceConfig as Config
        from kraken_tpu.lib import telemetry
        from kraken_tpu.models import load_models
        kwargs = {'precision': '32-true'}
    else:
        from kraken_tpu_torch.configs import SegmentationInferenceConfig as Config
        from kraken_tpu_torch.lib import telemetry
        from kraken_tpu_torch.models import load_models
        kwargs = {'device': 'cpu'}
    im = Image.open(PAGE)
    model = load_models(MODEL)[0]
    out = {}
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        for route, options in ROUTES.items():
            model.prepare_for_inference(Config(**kwargs, **options))
            with telemetry.collect() as stats:
                seg = model.predict(im)
            out[route] = (seg_record(seg), stats.up_bytes, stats.down_bytes, model._seg_transfer)
    return out


@pytest.fixture(scope='module')
def routes():
    return {'jax': _run_routes('jax'), 'port': _run_routes('port')}


@pytest.mark.parametrize('route', list(ROUTES))
def test_route_segmentation_equals_jax(routes, route):
    """Every route gives the float route's Segmentation but the width
    bucket's, whose wider upsampling grid moves the heatmaps (in both
    packages alike)."""
    got, want = routes['port'][route], routes['jax'][route]
    assert len(got[0]['lines']) == 46
    assert got[0] == want[0]
    assert (got[0] == routes['port']['float'][0]) == (route != 'width_bucketing')


@pytest.mark.parametrize('route', list(ROUTES))
def test_route_bytes_equal_jax(routes, route):
    """Bytes up and down a page, and the transfer the route took ('auto'
    takes 'uint8' on the CPU's link in both packages)."""
    assert routes['port'][route][1:] == routes['jax'][route][1:]


def test_route_byte_counts(routes):
    """The fixture page's transfers: the page up as floats or bytes; the
    float heatmaps and ridge masks, the uint8 heatmaps and ridge masks, or
    the 10 packed masks of 512 x 45 bytes down."""
    port = routes['port']
    assert port['float'][1:3] == (2_174_976, 7_974_912)
    assert port['uint8_input'][1:3] == (543_744, 7_974_912)
    assert port['uint8_heatmaps'][1:3] == (2_174_976, 2_537_472)
    assert port['packbits'][1:3] == (2_174_976, 10 * 512 * 45)
    assert port['auto'][3] == 'uint8'


def test_packbits_page_batch_equals_jax():
    """Two pages in one forward: the max filter and the thresholds see the
    bucket's pad columns before the host crops them, as in the JAX
    program."""
    from kraken_tpu.configs import SegmentationInferenceConfig as JaxConfig
    from kraken_tpu.inference.segmentation import segmentation_pred_batch as jax_batch
    from kraken_tpu.lib import telemetry as jax_telemetry
    from kraken_tpu.models import load_models as jax_load_models
    from kraken_tpu_torch.configs import SegmentationInferenceConfig
    from kraken_tpu_torch.inference.segmentation import segmentation_pred_batch
    from kraken_tpu_torch.lib import telemetry
    from kraken_tpu_torch.models import load_models
    pages = [Image.open(PAGE), Image.open(RESOURCES / 'input.jpg')]
    jm = jax_load_models(MODEL)[0]
    jm.prepare_for_inference(JaxConfig(precision='32-true', heatmap_precision='packbits'))
    tm = load_models(MODEL)[0]
    tm.prepare_for_inference(SegmentationInferenceConfig(device='cpu',
                                                         heatmap_precision='packbits'))
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        with jax_telemetry.collect() as jax_stats:
            want = jax_batch(jm, pages)
    with telemetry.collect() as stats:
        got = segmentation_pred_batch(tm, pages)
    assert [seg_record(s) for s in got] == [seg_record(s) for s in want]
    assert len(got[0].lines) > 20
    assert (stats.up_bytes, stats.down_bytes) == (jax_stats.up_bytes, jax_stats.down_bytes)


def test_packbits_falls_back_to_uint8_like_jax():
    """'packbits' needs the ridge's baseline channels and both separators:
    a class mapping without separators takes 'uint8' in both packages."""
    from kraken_tpu.configs import SegmentationInferenceConfig as JaxConfig
    from kraken_tpu.vgsl import VGSLModel as JaxVGSLModel
    from kraken_tpu_torch.configs import SegmentationInferenceConfig
    from kraken_tpu_torch.vgsl import VGSLModel
    mapping = {'baselines': {'a': 2, 'b': 3}, 'regions': {'r': 6}}
    jm = JaxVGSLModel(vgsl=NARROW_SPEC, rng=jax.random.PRNGKey(0))
    tm = VGSLModel(NARROW_SPEC)
    for m in (jm, tm):
        m.model_type = 'segmentation'
        m.user_metadata['class_mapping'] = mapping
    jm.prepare_for_inference(JaxConfig(heatmap_precision='packbits'))
    tm.prepare_for_inference(SegmentationInferenceConfig(device='cpu',
                                                         heatmap_precision='packbits'))
    assert tm._seg_transfer == jm._seg_transfer == 'uint8'


def test_link_probe_runs_once_a_route_key(monkeypatch):
    """'auto' probes once for a (device, input_transfer, heatmap_precision)
    and keeps its choice while the model is prepared page after page; a
    slow link takes 'packbits'."""
    from kraken_tpu_torch.configs import SegmentationInferenceConfig
    from kraken_tpu_torch.inference import segmentation
    from kraken_tpu_torch.models import load_models
    from kraken_tpu_torch.ops.segmask import probe_link_mbps
    assert probe_link_mbps('cpu') > 500
    calls = []
    monkeypatch.setattr(segmentation, 'probe_link_mbps', lambda d: calls.append(d) or 100.0)
    model = load_models(MODEL)[0]
    config = SegmentationInferenceConfig(device='cpu', heatmap_precision='auto')
    for _ in range(3):
        model.prepare_for_inference(config)
    assert model._seg_transfer == 'packbits' and len(calls) == 1
    model.prepare_for_inference(SegmentationInferenceConfig(device='cpu', heatmap_precision='auto',
                                                            input_transfer='uint8'))
    assert len(calls) == 2


def _feature_page():
    img = np.full((200, 400), 255, np.uint8)
    for y0 in (38, 78, 108, 148):
        img[y0:y0 + 14, 30:370] = 60
    baselines = [[[30, y + 14], [200, y + 12], [370, y + 14]] for y in (38, 78, 108, 148)]
    return img, baselines


@pytest.mark.parametrize('topline', [False, True, None])
def test_device_carver_polygons_equal_host_and_jax(topline):
    from kraken_tpu.lib import polygonization as jp
    from kraken_tpu_torch.lib import polygonization as tp
    img, baselines = _feature_page()
    feats = tp.gradient_feature_map(img)
    jobs = [(bl, baselines[:i] + baselines[i + 1:]) for i, bl in enumerate(baselines)]
    want = jp.polygonize_page(jobs, feats, topline=topline, seam_carver='device')
    assert all(p is not None for p in want)
    assert tp.polygonize_page(jobs, feats, topline=topline, seam_carver='device',
                              device='cpu') == want
    assert tp.polygonize_page(jobs, feats, topline=topline) == want
    im = Image.fromarray(img)
    env = tp.calculate_polygonal_environment(im, baselines, topline=topline,
                                             seam_carver='device', device='cpu')
    assert env == jp.calculate_polygonal_environment(im, baselines, topline=topline,
                                                     seam_carver='device')
    assert env == tp.calculate_polygonal_environment(im, baselines, topline=topline)


def test_device_carver_all_lines_failed():
    """Every line failing native preparation leaves an empty patch list."""
    from kraken_tpu_torch.lib.polygonization import polygonize_page
    jobs = [([[10, 10], [10, 10]], []), ([[5, 5], [5, 5]], [])]
    out = polygonize_page(jobs, np.zeros((50, 50), np.float32), seam_carver='device',
                          device='cpu')
    assert out == [None, None]


def test_device_carver_raise_on_error_path_equals_jax():
    """raise_on_error=True skips the native polygonizer: the batched Python
    path (_polygonize_batched) carves the page's patches in one call, and a
    failing line raises in both packages."""
    from kraken_tpu.lib import polygonization as jp
    from kraken_tpu_torch.lib import polygonization as tp
    img, baselines = _feature_page()
    feats = tp.gradient_feature_map(img)
    jobs = [(bl, baselines[:i] + baselines[i + 1:]) for i, bl in enumerate(baselines)]
    got = tp.polygonize_page(jobs, feats, raise_on_error=True, seam_carver='device',
                             device='cpu')
    assert got == jp.polygonize_page(jobs, feats, raise_on_error=True, seam_carver='device')
    assert all(p is not None for p in got)
    im = Image.fromarray(img)
    assert tp.calculate_polygonal_environment(im, baselines, raise_on_error=True,
                                              seam_carver='device', device='cpu') == \
        jp.calculate_polygonal_environment(im, baselines, raise_on_error=True,
                                           seam_carver='device')
    bad = [([[10, 10], [10, 10]], [])] + jobs
    with pytest.raises(Exception):
        jp.polygonize_page(bad, feats, raise_on_error=True, seam_carver='device')
    with pytest.raises(Exception):
        tp.polygonize_page(bad, feats, raise_on_error=True, seam_carver='device', device='cpu')


def test_device_carver_defaults_to_the_card(monkeypatch):
    """Without a card, the device carver's default device raises; the host
    carver, the port's default, needs none."""
    from kraken_tpu_torch.lib import polygonization as tp
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    img, baselines = _feature_page()
    feats = tp.gradient_feature_map(img)
    jobs = [(bl, baselines[:i] + baselines[i + 1:]) for i, bl in enumerate(baselines)]
    assert all(p is not None for p in tp.polygonize_page(jobs, feats))
    with pytest.raises((RuntimeError, AssertionError)):
        tp.polygonize_page(jobs, feats, seam_carver='device')
