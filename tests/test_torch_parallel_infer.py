"""
Inference over several devices in one process (the inference configs'
``devices``, ``parallel/mesh.py:make_infer_fn``) against the JAX package's
sharded inference on its 8-device CPU mesh (tests/conftest.py), with CPU
shards:

- ``make_infer_fn`` over 8 CPU shards gives the JAX ``make_infer_fn``'s
  labels and output lengths and its confidences within 1e-6, on a full and
  on a ragged batch (which the port pads to the shard count);
- ``devices=8`` recognition reproduces the golden predictions on three
  lines, a batch that does not split evenly (tests/test_parallel.py:
  113-140), and equals the JAX package's ``devices=8`` records; on every
  input route two shards give the one-device records, confidences bit for
  bit;
- ``devices=8`` segmentation equals the one-device segmentation of a page
  and of a two-page batch (tests/test_parallel.py:166-200), on the fused
  and the un-fused ridge routes;
- ``kraken segment/ocr --devices 2 -d cpu`` write what ``--devices 1``
  writes;
- ``devices=2`` on ``cuda`` without two cards raises.
"""
import tests.test_torch_threads  # noqa: F401  (first: the thread share under xdist)
import dataclasses
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from click.testing import CliRunner
from PIL import Image

RESOURCES = Path(__file__).resolve().parent / 'resources'
SPEC = '[1,16,0,1 Cr3,3,4,2,2 S1(1x0)1,3 Lbx8 O1c6]'
BL_GOLD = '.ܗ ܣܗܐ  ܕ ܣ   ܗ ܕܗܗ ܟܕܗܣ    ܠ  ܐ .ܣܕܐܣ. ܗ '
CONF_ATOL = 1e-6
# the port's records against the JAX package's: the same network sums its
# convolutions in another order than XLA (tests/test_torch_extraction.py)
JAX_CONF_ATOL = 2e-5


@pytest.fixture(scope='module', autouse=True)
def quiet():
    warnings.filterwarnings('ignore', category=DeprecationWarning)
    warnings.filterwarnings('ignore', category=UserWarning)


@pytest.fixture(scope='module')
def jax_infer():
    """A small recognizer in both packages (the port's from the JAX
    weights), a ragged batch and the JAX make_infer_fn's outputs over the
    8-device mesh."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from kraken_tpu.parallel import make_infer_fn, make_mesh, replicate
    from kraken_tpu.vgsl import VGSLModel as JaxVGSLModel
    from kraken_tpu_torch.vgsl import VGSLModel
    jm = JaxVGSLModel(vgsl=SPEC, rng=jax.random.PRNGKey(0))
    tm = VGSLModel(SPEC)
    tm.from_jax_state_dict(jm.state_dict())
    tm.net.eval()
    rng = np.random.RandomState(3)
    x = rng.rand(16, 1, 16, 64).astype(np.float32)
    lens = rng.randint(8, 65, 16).astype(np.int32)
    mesh = make_mesh(jax.devices())
    data = NamedSharding(mesh, P('data'))
    fn = make_infer_fn(jm.net, mesh)
    want = fn(jax.device_put(jm.params, replicate(mesh)), jax.device_put(jnp.asarray(x), data),
              jax.device_put(jnp.asarray(lens), data))
    return tm, x, lens, tuple(np.asarray(a) for a in want)


@pytest.mark.parametrize('rows', [16, 13])
def test_make_infer_fn_equals_jax(jax_infer, rows):
    from kraken_tpu_torch.parallel import make_infer_fn
    tm, x, lens, (labels, confs, olens) = jax_infer
    got = make_infer_fn(tm.net, ['cpu'] * 8)(x[:rows], lens[:rows])
    assert [a.shape[0] for a in got] == [rows] * 3
    np.testing.assert_array_equal(got[0], labels[:rows])
    np.testing.assert_allclose(got[1], confs[:rows], atol=CONF_ATOL)
    np.testing.assert_array_equal(got[2], olens[:rows])


def test_make_infer_fn_equals_one_device(jax_infer):
    """Three shards of a batch of 13 against the unsharded forward."""
    from kraken_tpu_torch.parallel import make_infer_fn
    tm, x, lens, _ = jax_infer
    one = make_infer_fn(tm.net, ['cpu'])(x[:13], lens[:13])
    three = make_infer_fn(tm.net, ['cpu'] * 3)(x[:13], lens[:13])
    for a, b in zip(one, three):
        np.testing.assert_array_equal(a, b)


def _three_lines(package: str):
    if package == 'jax':
        from kraken_tpu.containers import BaselineLine, Segmentation
    else:
        from kraken_tpu_torch.containers import BaselineLine, Segmentation
    line = BaselineLine(id='l0', baseline=[[0, 10], [2543, 10]],
                        boundary=[[0, 0], [2543, 0], [2543, 155], [0, 155]])
    return Segmentation(type='baselines', imagename=RESOURCES / 'bw.png',
                        text_direction='horizontal-lr', script_detection=False,
                        lines=[dataclasses.replace(line, id=f'l{i}') for i in range(3)])


def _port_records(devices: int, **kwargs) -> list:
    from kraken_tpu_torch.configs import RecognitionInferenceConfig
    from kraken_tpu_torch.models import load_models
    model = load_models(RESOURCES / 'overfit.mlmodel')[0]
    model.prepare_for_inference(RecognitionInferenceConfig(
        device='cpu', batch_size=3, num_line_workers=0, padding=1, devices=devices, **kwargs))
    assert (model._shard_devices is None) == (devices == 1)
    return list(model.predict(Image.open(RESOURCES / '000236.png'), _three_lines('port')))


def test_sharded_recognition_matches_golden_and_jax():
    from kraken_tpu.configs import RecognitionInferenceConfig as JaxConfig
    from kraken_tpu.models import load_models as jax_load_models
    got = _port_records(8)
    assert [r.prediction for r in got] == [BL_GOLD] * 3
    jm = jax_load_models(RESOURCES / 'overfit.mlmodel')[0]
    jm.prepare_for_inference(JaxConfig(batch_size=3, num_line_workers=0, padding=1, devices=8))
    assert jm._mesh is not None and jm._mesh.devices.size == 8
    want = list(jm.predict(Image.open(RESOURCES / '000236.png'), _three_lines('jax')))
    assert [r.prediction for r in got] == [r.prediction for r in want]
    assert [r.cuts for r in got] == [r.cuts for r in want]
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.confidences, b.confidences, atol=JAX_CONF_ATOL)


@pytest.mark.parametrize('route', [{}, {'input_transfer': 'uint8'}, {'input_transfer': 'packed'},
                                   {'line_extraction': 'device'},
                                   {'line_extraction': 'device', 'return_logits': True}],
                         ids=['float', 'uint8', 'packed', 'device', 'device_logits'])
def test_two_shards_equal_one_device_on_every_route(route):
    one, two = _port_records(1, **route), _port_records(2, **route)
    assert [r.prediction for r in two] == [r.prediction for r in one] == [BL_GOLD] * 3
    for a, b in zip(one, two):
        assert a.cuts == b.cuts and a.confidences == b.confidences
        if route.get('return_logits'):
            np.testing.assert_array_equal(a.logits, b.logits)


def _segment(devices: int, fused: bool) -> tuple:
    from kraken_tpu_torch.configs import SegmentationInferenceConfig
    from kraken_tpu_torch.inference.segmentation import (prepare_segmentation,
                                                         segmentation_pred,
                                                         segmentation_pred_batch)
    from kraken_tpu_torch.models import load_models
    from tests.test_torch_segmentation import seg_record
    im = Image.open(RESOURCES / 'input.webp')
    im = im.resize((im.width // 3, im.height // 3))
    model = load_models(RESOURCES / 'blla_small.safetensors')[0]
    prepare_segmentation(model, SegmentationInferenceConfig(device='cpu', devices=devices,
                                                            fused_ridge=fused))
    assert (model._seg_shards is None) == (devices == 1)
    return (seg_record(segmentation_pred(model, im)),
            [seg_record(s) for s in segmentation_pred_batch(model, [im, im.copy()])])


@pytest.mark.parametrize('fused', [True, False], ids=['fused', 'unfused'])
def test_sharded_segmentation_equals_one_device(fused):
    """One page on 8 shards (seven of blank padding) and a two-page batch."""
    ref, got = _segment(1, fused), _segment(8, fused)
    assert len(ref[0]['lines']) > 0
    assert got == ref


def _cli(tmp_path, devices: int) -> tuple:
    """``segment -bl`` to JSON, and ``segment -bl ocr`` to text, both with
    ``--devices``, on a third of the input page (the small segmenter)."""
    from kraken_tpu_torch import kraken
    out = tmp_path / f'devices_{devices}'
    out.mkdir()
    page = out / 'page.png'
    im = Image.open(RESOURCES / 'input.webp')
    im.resize((im.width // 3, im.height // 3)).save(page)
    n = str(devices)
    seg = ['segment', '-bl', '-i', str(RESOURCES / 'blla_small.safetensors'), '--devices', n]
    for dst, args in ((out / 'seg.json', seg),
                      (out / 'page.txt', seg + ['ocr', '-m', str(RESOURCES / 'overfit_bl.safetensors'),
                                                '--devices', n])):
        result = CliRunner().invoke(kraken.cli, ['-d', 'cpu', '-i', str(page), str(dst), *args])
        assert result.exit_code == 0, result.output
    return (out / 'seg.json').read_text(), (out / 'page.txt').read_text()


def test_cli_devices_equal_one_device(tmp_path):
    from kraken_tpu_torch.containers import Segmentation
    from tests.test_torch_segmentation import seg_record
    import json
    (seg1, text1), (seg2, text2) = _cli(tmp_path, 1), _cli(tmp_path, 2)
    assert seg_record(Segmentation(**json.loads(seg2))) == \
        seg_record(Segmentation(**json.loads(seg1)))
    assert text2 == text1 and text1.strip()


def test_devices_on_cuda_without_the_cards_raises(monkeypatch):
    from kraken_tpu_torch.configs import RecognitionInferenceConfig, SegmentationInferenceConfig
    from kraken_tpu_torch.models import load_models
    from kraken_tpu_torch.parallel import inference_devices
    if not torch.cuda.is_available():
        model = load_models(RESOURCES / 'overfit.mlmodel')[0]
        with pytest.raises(RuntimeError, match='no CUDA device'):
            model.prepare_for_inference(RecognitionInferenceConfig(devices=2))
        seg = load_models(RESOURCES / 'blla_small.safetensors')[0]
        with pytest.raises(RuntimeError, match='no CUDA device'):
            seg.prepare_for_inference(SegmentationInferenceConfig(devices=2))
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    with pytest.raises(ValueError, match='devices=2 requested but only 1 CUDA'):
        inference_devices(2, 'cuda')
    assert inference_devices(3, 'cpu') == [torch.device('cpu')] * 3
