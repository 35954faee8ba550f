"""
The port's BLLA segmentation (kraken_tpu_torch.inference.segmentation and
what it calls) against the JAX package on the CPU:

- the host half is exactly equal: the JAX maps (heatmaps, ridge masks,
  scaled page) of the fixture page give the same lines and regions through
  either package's vectorizer, as do the synthetic maps of
  tests/test_segmentation.py through vectorize_lines/vectorize_regions/
  polygonize_page, and the port's native library gives JAX's bytes;
- the shipped model end to end: ridge masks equal except at pixels within
  1e-5 of the threshold, the same Segmentation, and the detection and
  region floors of tests/test_seg_parity.py. Its heatmaps are held against
  a float64 witness that shares no code with either package (a numpy
  forward from the JAX model's weights): the port is within 5e-5 of it
  (fp32 convolutions round through 11 layers whose logits reach ~28) and
  JAX is more than 5e-5 off it, because the JAX GroupNorm takes its
  variance in fp32 in one sequential sum over up to 181k elements. So
  1e-5 of JAX's heatmaps is out of reach for any fp32 forward (on the
  fixture page: port 2.4e-5, JAX 1.2e-4 from the witness);
- a narrow spec shaped like the full-size one, with the JAX model's
  weights, on a batch of two pages of different widths (sequence lengths
  through GroupNorm): heatmaps within 1e-5;
- the golden Segmentation the GPU smoke test checks against
  (tests/resources/torch_seg_golden.json) is the JAX package's.

Write the golden anew with ``python -m tests.test_torch_segmentation``.
"""
import tests.test_torch_threads  # noqa: F401  (first: the thread share under xdist)
import json
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from PIL import Image

RESOURCES = Path(__file__).resolve().parent / 'resources'
PAGE = '170025120000003,0074'
GOLDEN = RESOURCES / 'torch_seg_golden.json'
THRESHOLD = 0.17
# a narrow net shaped like the default segmentation spec (7x7 stride-2 conv,
# 3x3 stride-2 conv, Gn after each conv, a 10-class heatmap head)
NARROW_SPEC = '[1,96,0,3 Cr7,7,8,2,2 Gn4 Cr3,3,16,2,2 Gn4 Cr3,3,16 Gn4 O2l10]'


def seg_record(seg) -> dict:
    """A Segmentation as plain JSON data without its uuids: lines in reading
    order (baseline, boundary, tags, containing regions as 'type/index'),
    regions by type."""
    names = {reg.id: f'{kind}/{i}' for kind, regs in seg.regions.items()
             for i, reg in enumerate(regs)}
    return {'lines': [{'baseline': [list(map(int, p)) for p in line.baseline],
                       'boundary': [list(map(int, p)) for p in line.boundary],
                       'tags': line.tags,
                       'regions': [names[r] for r in line.regions]}
                      for line in seg.lines],
            'regions': {kind: [[list(map(int, p)) for p in reg.boundary] for reg in regs]
                        for kind, regs in seg.regions.items()}}


def jax_fixture_run() -> tuple:
    """The JAX package's maps and Segmentation of the fixture page with the
    shipped model (fp32, default config)."""
    from kraken_tpu.configs import SegmentationInferenceConfig
    from kraken_tpu.inference.segmentation import (_compute_segmentation_maps,
                                                   _vectorize_page, prepare_segmentation)
    from kraken_tpu.models import load_models
    im = Image.open(RESOURCES / f'{PAGE}.jpg')
    model = load_models(RESOURCES / 'blla_small.safetensors')[0]
    prepare_segmentation(model, SegmentationInferenceConfig(precision='32-true'))
    rets = _compute_segmentation_maps(model, [im])[0]
    return model, rets, _vectorize_page(model, im, rets)


def _torch_model(device='cpu'):
    from kraken_tpu_torch.configs import SegmentationInferenceConfig
    from kraken_tpu_torch.lib.util import default_segmentation_model
    from kraken_tpu_torch.models import load_models
    model = load_models(default_segmentation_model())[0]
    model.prepare_for_inference(SegmentationInferenceConfig(device=device))
    return model


@pytest.fixture(scope='module')
def jax_page():
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        return jax_fixture_run()


@pytest.fixture(scope='module')
def torch_page():
    from kraken_tpu_torch.inference.segmentation import (_compute_segmentation_maps,
                                                         _vectorize_page)
    im = Image.open(RESOURCES / f'{PAGE}.jpg')
    model = _torch_model()
    rets = _compute_segmentation_maps(model, [im])[0]
    return model, rets, _vectorize_page(model, im, rets)


def _ridge_masks_agree(masks: dict, jax_rets: dict) -> None:
    """Masks equal JAX's except at pixels whose ridge response (the port's
    plain filter on the JAX heatmap) lies within 1e-5 of the threshold."""
    from kraken_tpu_torch.ops.ridge import sato_ridge_reference
    assert sorted(masks) == sorted(jax_rets['bin_maps'])
    for c, mask in masks.items():
        differ = mask != jax_rets['bin_maps'][c]
        if differ.any():
            resp = sato_ridge_reference(torch.from_numpy(
                np.ascontiguousarray(jax_rets['heatmap'][c]))[None])[0].numpy()
            assert (np.abs(resp[differ] - THRESHOLD) <= 1e-5).all(), c


# the layers of the shipped spec [1,512,0,3 Cr3,3,32,2,2 Gn8 Cr3,3,64,2,2 Gn16
# Cr3,3,96 Gn16 Cr3,3,96 Gn16 Cr3,3,64 Gn16 O2l10]: (weight prefix, stride or
# groups)
SHIPPED_LAYERS = [('C_0', 2), ('Gn_1', 8), ('C_2', 2), ('Gn_3', 16), ('C_4', 1), ('Gn_5', 16),
                  ('C_6', 1), ('Gn_7', 16), ('C_8', 1), ('Gn_9', 16), ('l_10', 1)]


def _bilinear_matrix(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) float64 weights of bilinear upsampling with half-pixel
    centres, source coordinates clamped to the input."""
    src = np.clip((np.arange(n_out) + 0.5) * n_in / n_out - 0.5, 0, n_in - 1)
    lo = np.floor(src).astype(int)
    hi = np.minimum(lo + 1, n_in - 1)
    m = np.zeros((n_out, n_in))
    np.add.at(m, (np.arange(n_out), lo), 1 - (src - lo))
    np.add.at(m, (np.arange(n_out), hi), src - lo)
    return m


def _float64_heatmaps(jax_model, x: np.ndarray, out_hw: tuple) -> np.ndarray:
    """The shipped network's heatmaps of the (C, H, W) input `x`, computed
    in numpy float64 from the JAX model's weights, with code of neither
    package: zero-padded convolutions with ReLU, GroupNorm over whole
    groups (eps 1e-5), the 1x1 linear head, bilinear upsampling and a
    sigmoid."""
    from numpy.lib.stride_tricks import sliding_window_view
    state = {k: np.asarray(v, np.float64) for k, v in jax_model.state_dict().items()}
    x = x.astype(np.float64)
    for name, arg in SHIPPED_LAYERS:
        if name.startswith('Gn'):
            g = x.reshape(arg, -1)
            g = (g - g.mean(1, keepdims=True)) / np.sqrt(g.var(1, keepdims=True) + 1e-5)
            x = g.reshape(x.shape) * state[f'nn.{name}.layer.weight'][:, None, None] \
                + state[f'nn.{name}.layer.bias'][:, None, None]
            continue
        w, b = state[f'nn.{name}.co.weight'], state[f'nn.{name}.co.bias']
        k = w.shape[-1]
        xp = np.pad(x, ((0, 0), (k // 2, k // 2), (k // 2, k // 2)))
        win = sliding_window_view(xp, (k, k), axis=(1, 2))[:, ::arg, ::arg]
        x = np.tensordot(w, win, axes=([1, 2, 3], [0, 3, 4])) + b[:, None, None]
        if name.startswith('C'):
            x = np.maximum(x, 0)
    x = np.einsum('oh,chw,pw->cop', _bilinear_matrix(out_hw[0], x.shape[1]), x,
                  _bilinear_matrix(out_hw[1], x.shape[2]))
    return 1 / (1 + np.exp(-x))


def test_shipped_model_heatmaps_match_jax(jax_page, torch_page):
    from kraken_tpu_torch.dataset import ImageInputTransforms
    from kraken_tpu_torch.inference.segmentation import _page_resize
    heat_t, heat_j = torch_page[1]['heatmap'], jax_page[1]['heatmap']
    assert heat_t.shape == heat_j.shape == (10, 512, 354)
    assert heat_t.dtype == np.float32
    _, C, H, W = torch_page[0].input
    transforms = ImageInputTransforms(1, H, W, C, 0, valid_norm=False)
    page = Image.open(RESOURCES / f'{PAGE}.jpg').convert(transforms.mode)
    x = transforms.tail(_page_resize(page, transforms.scale))
    exact = _float64_heatmaps(jax_page[0], x, heat_j.shape[1:])
    err_t, err_j = np.abs(heat_t - exact).max(), np.abs(heat_j - exact).max()
    # the port is close to the witness; JAX is measurably farther off
    assert err_t <= 5e-5 < err_j, (err_t, err_j)
    np.testing.assert_allclose(heat_t, heat_j, atol=2e-4)
    _ridge_masks_agree(torch_page[1]['bin_maps'], jax_page[1])
    np.testing.assert_array_equal(torch_page[1]['scal_im'], jax_page[1]['scal_im'])
    np.testing.assert_array_equal(torch_page[1]['scale'], jax_page[1]['scale'])


def test_shipped_model_segmentation_equals_jax(jax_page, torch_page):
    got, want = seg_record(torch_page[2]), seg_record(jax_page[2])
    assert len(got['lines']) == len(want['lines']) == 46
    assert got == want
    assert torch_page[2].type == 'baselines' and torch_page[2].script_detection


@pytest.mark.parametrize('ridge', ['jax', 'port'])
def test_host_half_equals_jax_on_jax_maps(jax_page, torch_page, ridge):
    """The port's vectorizer, given the JAX package's heatmaps and scaled
    page, gives exactly the JAX package's Segmentation: with the JAX ridge
    masks, and with the masks the port's ridge filter (its plain version)
    makes of the JAX heatmaps."""
    from kraken_tpu_torch.inference.segmentation import _vectorize_page
    from kraken_tpu_torch.ops.ridge import sato_ridge_threshold
    im = Image.open(RESOURCES / f'{PAGE}.jpg')
    rets = dict(jax_page[1])
    if ridge == 'port':
        channels = sorted(rets['bin_maps'])
        masks = sato_ridge_threshold(torch.from_numpy(np.array(rets['heatmap']))[None],
                                     channels, THRESHOLD)[0].numpy()
        rets['bin_maps'] = {c: m.astype(bool) for c, m in zip(channels, masks)}
    assert seg_record(_vectorize_page(torch_page[0], im, rets)) == seg_record(jax_page[2])


def test_golden_is_the_jax_segmentation(jax_page):
    assert json.loads(GOLDEN.read_text()) == seg_record(jax_page[2])


def test_detection_floors(torch_page):
    """The floors of tests/test_seg_parity.py on the port's Segmentation."""
    from kraken_tpu.lib.geometry import make_polygonal_mask
    from kraken_tpu.lib.segmentation_metrics import (compute_detection_metrics,
                                                     interpolate_polyline)
    from kraken_tpu.xml import XMLPage
    gt = XMLPage(RESOURCES / f'{PAGE}.xml').to_container()
    pred = torch_page[2]
    det = compute_detection_metrics(
        [interpolate_polyline(np.array(line.baseline, float)) for line in pred.lines],
        [interpolate_polyline(np.array(line.baseline, float)) for line in gt.lines], tol=25.0)
    assert det['f1'] >= 0.93 and det['precision'] >= 0.90 and det['recall'] >= 0.95, det
    im = Image.open(RESOURCES / f'{PAGE}.jpg')

    def region_mask(seg):
        m = np.zeros((im.height, im.width), bool)
        for regs in seg.regions.values():
            for r in regs:
                if r.boundary:
                    m |= np.asarray(make_polygonal_mask(np.array(r.boundary),
                                                        (im.width, im.height))) > 0
        return m
    pm, gm = region_mask(pred), region_mask(gt)
    assert (pm & gm).sum() / (pm | gm).sum() >= 0.90


@pytest.fixture(scope='module')
def synthetic_maps():
    # the maps of tests/test_segmentation.py
    from scipy.ndimage import gaussian_filter
    H, W = 200, 400
    bl_map = np.zeros((H, W), np.float32)
    bl_map[50, 30:370] = 1.0
    bl_map[120, 40:350] = 1.0
    bl_map = np.clip(gaussian_filter(bl_map, 2) * 6, 0, 1)
    st_map = np.zeros_like(bl_map)
    st_map[40:60, 25:45] = 1.0
    st_map[110:130, 35:55] = 1.0
    end_map = np.zeros_like(bl_map)
    end_map[40:60, 355:375] = 1.0
    end_map[110:130, 340:360] = 1.0
    return np.stack([st_map, end_map, bl_map])


@pytest.mark.parametrize('order', [(0, 1, 2), (1, 0, 2)])
def test_vectorize_lines_equals_jax(synthetic_maps, order):
    """The port's ridge mask (plain version) and vectorizer give the JAX
    package's host ridge mask and baselines."""
    from kraken_tpu.lib import vectorization as jv
    from kraken_tpu_torch.lib import vectorization as tv
    from kraken_tpu_torch.ops.ridge import sato_ridge_threshold
    maps = synthetic_maps[list(order)]
    want = jv.vectorize_lines(maps)
    assert len(want) == 2
    mask = sato_ridge_threshold(torch.from_numpy(np.ascontiguousarray(maps))[None], [2],
                                THRESHOLD)[0, 0].numpy().astype(bool)
    np.testing.assert_array_equal(mask, jv.sato_ridge(maps[2]) > THRESHOLD)
    assert tv.vectorize_lines(maps, bin_map=mask) == want


def test_vectorize_regions_equals_jax():
    from kraken_tpu.lib import vectorization as jv
    from kraken_tpu_torch.lib import vectorization as tv
    region_map = np.zeros((200, 400), np.float32)
    region_map[30:140, 20:380] = 1.0
    region_map[160:190, 50:120] = 0.8
    assert tv.vectorize_regions(region_map) == jv.vectorize_regions(region_map)


@pytest.mark.parametrize('topline', [False, True, None])
def test_polygonize_page_equals_jax(topline):
    from kraken_tpu.lib import polygonization as jp
    from kraken_tpu_torch.lib import polygonization as tp
    img = np.full((200, 400), 255, np.uint8)
    for y0 in (38, 78, 108, 148):
        img[y0:y0 + 14, 30:370] = 60
    baselines = [[[30, y + 14], [200, y + 12], [370, y + 14]] for y in (38, 78, 108, 148)]
    feats_j = jp.gradient_feature_map(img)
    feats_t = tp.gradient_feature_map(img)
    np.testing.assert_array_equal(feats_t, feats_j)
    jobs = [(bl, baselines[:i] + baselines[i + 1:]) for i, bl in enumerate(baselines)]
    want = jp.polygonize_page(jobs, feats_j, topline=topline, seam_carver='host')
    assert all(p is not None for p in want)
    assert tp.polygonize_page(jobs, feats_t, topline=topline) == want
    assert tp.calculate_polygonal_environment(Image.fromarray(img), baselines, topline=topline) \
        == jp.calculate_polygonal_environment(Image.fromarray(img), baselines, topline=topline)


def test_native_library_matches_jax():
    """Thinning, endpoints, seam carving and the Lanczos resize of the
    port's native library give the JAX package's bytes."""
    from kraken_tpu import native as jn
    from kraken_tpu_torch import native as tn
    assert tn.available() and jn.available()
    assert tn.BUILD_DIR.name == '_build' and (tn.BUILD_DIR / '_native.so').is_file()
    rng = np.random.RandomState(7)
    mask = np.zeros((60, 90), bool)
    mask[10:16, 5:80] = True
    mask[30:45, 20:40] = True
    mask |= rng.rand(60, 90) > 0.97
    skel = tn.skeletonize_native(mask)
    np.testing.assert_array_equal(skel, jn.skeletonize_native(mask))
    np.testing.assert_array_equal(tn.endpoints_native(skel), jn.endpoints_native(skel))
    patch = np.pad(rng.rand(20, 50).astype(np.float32), ((1, 1), (0, 0)),
                   constant_values=np.inf)
    np.testing.assert_array_equal(tn.carve_seam_native(patch), jn.carve_seam_native(patch))
    for shape, (oh, ow) in (((93, 411), (120, 530)), ((300, 200, 3), (512, 341))):
        im = rng.randint(0, 256, shape, dtype=np.uint8)
        out = tn.resize_lanczos_native(im, oh, ow)
        assert out is not None
        np.testing.assert_array_equal(out, jn.resize_lanczos_native(im, oh, ow))


def test_narrow_spec_page_batch_matches_jax():
    """Two pages of different widths in one forward: the narrower page's
    valid width reaches every GroupNorm as its sequence length."""
    from kraken_tpu.configs import SegmentationInferenceConfig as JaxConfig
    from kraken_tpu.inference import segmentation as jseg
    from kraken_tpu.vgsl import VGSLModel as JaxVGSLModel
    from kraken_tpu_torch.configs import SegmentationInferenceConfig
    from kraken_tpu_torch.inference import segmentation as tseg
    from kraken_tpu_torch.vgsl import VGSLModel
    class_mapping = {'aux': {'_start_separator': 0, '_end_separator': 1},
                     'baselines': {'a': 2, 'b': 3, 'c': 4, 'd': 5},
                     'regions': {'a': 6, 'b': 7, 'c': 8, 'd': 9}}
    jm = JaxVGSLModel(vgsl=NARROW_SPEC, rng=jax.random.PRNGKey(3))
    tm = VGSLModel(NARROW_SPEC)
    tm.from_jax_state_dict(jm.state_dict())
    for m in (jm, tm):
        m.model_type = 'segmentation'
        m.user_metadata['class_mapping'] = class_mapping
    jm.prepare_for_inference(JaxConfig(precision='32-true'))
    tm.prepare_for_inference(SegmentationInferenceConfig(device='cpu'))
    pages = [Image.open(RESOURCES / f'{PAGE}.jpg'), Image.open(RESOURCES / 'input.jpg')]
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        want = jseg._compute_segmentation_maps(jm, pages)
    got = tseg._compute_segmentation_maps(tm, pages)
    assert got[0]['heatmap'].shape != got[1]['heatmap'].shape
    for g, w in zip(got, want):
        assert g['heatmap'].shape == w['heatmap'].shape
        np.testing.assert_allclose(g['heatmap'], w['heatmap'], atol=1e-5)
        _ridge_masks_agree(g['bin_maps'], w)
    # and the batch entry point vectorizes both pages
    segs = tseg.segmentation_pred_batch(tm, pages)
    assert len(segs) == 2 and all(s.type == 'baselines' for s in segs)


@pytest.mark.parametrize('container', ['safetensors', 'coreml'])
def test_segmentation_model_files_load(tmp_path, container):
    """The shipped segmentation model loads with its metadata and weights
    from the port's safetensors copy and from a CoreML file the JAX
    package writes (the CoreML ``blla.mlmodel`` drop-in takes the same
    path)."""
    from kraken_tpu.models import load_models as jax_load_models
    from kraken_tpu.models._coreml_writer import write_coreml
    from kraken_tpu_torch.models import load_models
    jm = jax_load_models(RESOURCES / 'blla_small.safetensors')[0]
    path = RESOURCES / 'blla_small.safetensors'
    if container == 'coreml':
        path = tmp_path / 'blla.mlmodel'
        write_coreml([jm], path)
    model = load_models(path)[0]
    assert model.model_type == ['segmentation'] and model.seg_type == 'baselines'
    for key in ('class_mapping', 'topline', 'one_channel_mode'):
        assert model.user_metadata[key] == jm.user_metadata[key], key
    want = jm.state_dict()
    got = model.state_dict()
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value, err_msg=key)


def test_entry_points_default_to_cuda(monkeypatch):
    from kraken_tpu_torch import blla
    from kraken_tpu_torch.configs import SegmentationInferenceConfig
    from kraken_tpu_torch.models import load_models
    from kraken_tpu_torch.tasks import SegmentationTaskModel
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    assert SegmentationInferenceConfig().device == 'cuda'
    im = Image.open(RESOURCES / 'bw.png')
    model = load_models(RESOURCES / 'blla_small.safetensors')[0]
    assert model.user_metadata['class_mapping']['baselines']['$pag'] == 2
    assert model.seg_type == 'baselines' and model.user_metadata['topline'] is False
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        with pytest.raises(RuntimeError, match='no CUDA device'):
            blla.segment(im, model=model)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        SegmentationTaskModel.load_model().predict(im, SegmentationInferenceConfig())
    assert model.device.type == 'cpu'


if __name__ == '__main__':
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        GOLDEN.write_text(json.dumps(seg_record(jax_fixture_run()[2]), separators=(',', ':')) + '\n')
    print(f'wrote {GOLDEN}')
