"""
The port's neural reading order (kraken_tpu_torch.ro, the reading-order
half of .lib.geometry and .tasks.segmentation, the loaders and the CLI)
against the JAX package on the CPU:

- ``ROMLP``: its forward within 1e-6 of the JAX model's on the same
  parameters (carried by ``from_jax_state_dict``), its state dict under
  the file keys, the JAX errors of ``load_state_dict``;
- ``element_features`` and ``greedy_order_decode`` equal to JAX's;
- loading: the reading-order fixture ``ro_small.safetensors`` and a CoreML
  segmenter with reading-order ``aux_layers`` (written by the JAX
  package's CoreML writer) give the JAX loader's models, parameters,
  class mappings and levels;
- ``SegmentationTaskModel.predict`` of the fixture page with
  ``blla_small.safetensors`` and the reading-order model: the JAX
  package's ``line_orders``, with line-level, region-level and both
  models; the CLI's ``segment -bl -i seg -i ro`` JSON equal to the JAX
  CLI's;
- the golden the card's run is held to (``torch_ro_golden.json``: the JAX
  package's pair probabilities and neural order of the fixture page) is
  what the JAX package computes now, and the port is within 1e-6 of its
  probabilities.

``ro_small.safetensors`` is a reading-order model trained for one epoch
by the JAX package's ``ketos rotrain`` on the fixture page (CHANGES.md
gives the commands). Write the golden anew with
``JAX_PLATFORMS=cpu python -m tests.test_torch_ro``.
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
PAGE = RESOURCES / '170025120000003,0074.jpg'
SEG = RESOURCES / 'blla_small.safetensors'
RO = RESOURCES / 'ro_small.safetensors'
GOLDEN = RESOURCES / 'torch_ro_golden.json'
XML = RESOURCES / '170025120000003,0074.xml'


def jax_romlp(seed: int, class_mapping: dict, level: str = 'baselines'):
    from kraken_tpu.ro.layers import ROMLP
    return ROMLP(rng=jax.random.PRNGKey(seed), class_mapping=class_mapping, level=level)


def fresh_like(jax_model):
    """A fresh port ROMLP with the JAX model's metadata."""
    from kraken_tpu_torch.ro import ROMLP
    return ROMLP(generator=torch.Generator().manual_seed(0), **jax_model.user_metadata)


def port_copy(jax_model):
    """The port's ROMLP with the JAX model's metadata and parameters."""
    model = fresh_like(jax_model)
    model.from_jax_state_dict({k: np.asarray(v) for k, v in jax_model.state_dict().items()})
    return model


def assert_same_romlp(port, jax_model) -> None:
    assert type(port).__name__ == 'ROMLP'
    assert port.model_type == jax_model.model_type == ['reading_order']
    assert (port.class_mapping, port.level) == (jax_model.class_mapping, jax_model.level)
    assert port.user_metadata == jax_model.user_metadata
    want = jax_model.state_dict()
    got = port.state_dict()
    assert sorted(got) == sorted(want) == ['nn.fc1.bias', 'nn.fc1.weight', 'nn.fc2.bias',
                                           'nn.fc2.weight']
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(value), err_msg=key)


@pytest.mark.parametrize('seed, classes', [(0, 1), (1, 5), (2, 10)])
def test_forward_within_jax(seed, classes):
    cm = {f'$c{i}': i for i in range(classes)}
    jm = jax_romlp(seed, cm)
    model = port_copy(jm)
    assert (model.feature_size, model.hidden_size) == (jm.feature_size, jm.hidden_size)
    x = np.random.RandomState(seed).rand(57, jm.feature_size).astype(np.float32)
    with torch.inference_mode():
        got = model(x).numpy()
    want = np.asarray(jm.forward(x))
    assert got.shape == want.shape == (57, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_fresh_models_take_the_generator():
    from kraken_tpu_torch.ro import ROMLP
    a, b = (ROMLP(generator=torch.Generator().manual_seed(3), class_mapping={'x': 0},
                  level='baselines') for _ in range(2))
    assert all(torch.equal(a.state_dict()[k], b.state_dict()[k]) for k in a.state_dict())
    assert a.state_dict()['nn.fc1.weight'].abs().max() <= (6 / (14 + 28)) ** 0.5
    assert not a.state_dict()['nn.fc1.bias'].any()


@pytest.mark.parametrize('missing', ['class_mapping', 'level'])
def test_missing_metadata_raises_as_jax(missing):
    from kraken_tpu.ro.layers import ROMLP as JaxROMLP
    from kraken_tpu_torch.models import create_model
    kwargs = {'class_mapping': {'x': 0}, 'level': 'baselines'}
    del kwargs[missing]
    with pytest.raises(ValueError) as jax_err:
        JaxROMLP(rng=jax.random.PRNGKey(0), **kwargs)
    with pytest.raises(ValueError, match=f'lack `{missing}`') as port_err:
        create_model('ROMLP', **kwargs)
    assert str(port_err.value) == str(jax_err.value)


@pytest.mark.parametrize('bad', ['missing', 'shape'])
def test_load_state_dict_errors_as_jax(bad):
    jm = jax_romlp(0, {'x': 0, 'y': 1})
    model = port_copy(jm)
    sd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    if bad == 'missing':
        del sd['nn.fc2.bias']
    else:
        sd['nn.fc1.weight'] = sd['nn.fc1.weight'][:, 1:]
    errors = []
    for target in (jm, model):
        with pytest.raises(ValueError) as err:
            target.load_state_dict(sd)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


@pytest.mark.parametrize('bad', ['unknown', 'missing', 'shape'])
def test_from_jax_state_dict_refuses(bad):
    from kraken_tpu_torch.exceptions import KrakenInvalidModelException
    jm = jax_romlp(0, {'x': 0})
    sd = {k: np.asarray(v) for k, v in jm.state_dict().items()}
    if bad == 'unknown':
        sd['nn.fc3.weight'] = sd['nn.fc2.weight']
    elif bad == 'missing':
        del sd['nn.fc1.bias']
    else:
        sd['nn.fc2.weight'] = sd['nn.fc2.weight'][:, :-1]
    with pytest.raises(KrakenInvalidModelException):
        fresh_like(jm).from_jax_state_dict(sd)


@pytest.mark.parametrize('seed', range(6))
def test_greedy_order_decode_equals_jax(seed):
    from kraken_tpu.lib.geometry import greedy_order_decode as jax_decode
    from kraken_tpu_torch.lib.geometry import greedy_order_decode
    rng = np.random.RandomState(seed)
    n = rng.randint(2, 40)
    P = rng.rand(n, n)
    np.fill_diagonal(P, 0)
    assert greedy_order_decode(P.copy()) == jax_decode(P.copy())


@pytest.fixture(scope='module')
def xml_pages():
    from kraken_tpu.xml import XMLPage as JaxXMLPage
    from kraken_tpu_torch.xml import XMLPage
    return JaxXMLPage(XML).to_container(), XMLPage(XML).to_container()


def test_element_features_equal_jax(xml_pages):
    """Every line and region of the fixture PageXML, with the segmenter's
    line and region class mappings."""
    from kraken_tpu.ro.features import element_features as jax_features
    from kraken_tpu_torch.models import load_models
    from kraken_tpu_torch.ro import element_features
    jax_page, page = xml_pages
    im_size = Image.open(PAGE).size
    cms = load_models(SEG)[0].user_metadata['class_mapping']
    pairs = [(jax_page.lines, page.lines, cms['baselines']),
             ([r for rs in jax_page.regions.values() for r in rs],
              [r for rs in page.regions.values() for r in rs], cms['regions'])]
    count = 0
    for jax_els, els, cm in pairs:
        assert len(els) == len(jax_els) > 0
        nc = max(cm.values()) + 1
        for a, b in zip(els, jax_els):
            tag, feats = element_features(a, im_size, cm, nc)
            jtag, jfeats = jax_features(b, im_size, cm, nc)
            assert tag == jtag and feats.dtype == jfeats.dtype and np.array_equal(feats, jfeats)
            count += 1
    assert count > 40


def test_safetensors_ro_model_loads_as_jax():
    from kraken_tpu.models import load_models as jax_load_models
    from kraken_tpu_torch.models import load_models
    got, want = load_models(RO), jax_load_models(RO)
    assert len(got) == len(want) == 1
    assert_same_romlp(got[0], want[0])
    assert load_models(RO, tasks=['segmentation']) == []


def test_safetensors_file_with_segmenter_and_ro_model(tmp_path):
    """One file holding both (the JAX writer's, as `ketos roadd` makes it)."""
    from kraken_tpu.models import load_models as jax_load_models, write_models
    from kraken_tpu_torch.models import load_models
    path = tmp_path / 'seg_ro.safetensors'
    write_models(jax_load_models(SEG) + jax_load_models(RO), path)
    got, want = load_models(path), jax_load_models(path)
    assert [type(m).__name__ for m in got] == [type(m).__name__ for m in want] \
        == ['VGSLModel', 'ROMLP']
    assert_same_romlp(got[1], want[1])


def test_coreml_aux_layers_load_as_jax(tmp_path):
    """A CoreML segmenter with line- and region-level reading-order layers:
    every model the JAX loader builds, with its parameters."""
    from kraken_tpu.models import load_models as jax_load_models
    from kraken_tpu.models._coreml_writer import write_coreml
    from kraken_tpu_torch.models import load_coreml, load_models
    seg = jax_load_models(SEG)[0]
    cm = seg.user_metadata['class_mapping']
    path = tmp_path / 'seg_ro.mlmodel'
    write_coreml([seg, jax_romlp(1, cm['baselines']), jax_romlp(2, cm['regions'], 'regions')],
                 path)
    want = jax_load_models(path)
    got = load_models(path)
    assert [type(m).__name__ for m in got] == [type(m).__name__ for m in want] \
        == ['VGSLModel', 'ROMLP', 'ROMLP']
    assert [m.level for m in got[1:]] == ['baselines', 'regions']
    for a, b in zip(got[1:], want[1:]):
        assert_same_romlp(a, b)
    assert len(load_coreml(path)) == 3


@pytest.fixture(scope='module')
def segmentations():
    """The fixture page's Segmentation without neural order, from either
    package, and the page's size."""
    from kraken_tpu.configs import SegmentationInferenceConfig as JaxConfig
    from kraken_tpu.models import load_models as jax_load_models
    from kraken_tpu.tasks import SegmentationTaskModel as JaxTask
    from kraken_tpu_torch.configs import SegmentationInferenceConfig
    from kraken_tpu_torch.tasks import SegmentationTaskModel
    im = Image.open(PAGE)
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        jax_seg = JaxTask(jax_load_models(SEG)).predict(im, JaxConfig())
    seg = SegmentationTaskModel.load_model(SEG).predict(im, SegmentationInferenceConfig(device='cpu'))
    return jax_seg, seg, im.size


def ro_sets():
    """The reading-order model collections the orders are compared on:
    the trained line model, a seeded region model, both."""
    from kraken_tpu.models import load_models as jax_load_models
    cm = jax_load_models(SEG)[0].user_metadata['class_mapping']
    line = jax_load_models(RO)[0]
    region = jax_romlp(7, cm['regions'], 'regions')
    return {'lines': [line], 'regions': [region], 'both': [line, region]}


@pytest.mark.parametrize('which', ['lines', 'regions', 'both'])
def test_line_orders_equal_jax(which, segmentations):
    from kraken_tpu.configs import SegmentationInferenceConfig as JaxConfig
    from kraken_tpu.models import load_models as jax_load_models
    from kraken_tpu.tasks import SegmentationTaskModel as JaxTask
    from kraken_tpu_torch.configs import SegmentationInferenceConfig
    from kraken_tpu_torch.models import load_models
    from kraken_tpu_torch.tasks import SegmentationTaskModel
    jax_seg, seg, im_size = segmentations
    jax_ros = ro_sets()[which]
    jax_task = JaxTask(jax_load_models(SEG) + jax_ros)
    task = SegmentationTaskModel(load_models(SEG) + [port_copy(m) for m in jax_ros])
    want = jax_task._compute_additional_line_orders(jax_seg, JaxConfig(), im_size=im_size)
    got = task._compute_additional_line_orders(seg, SegmentationInferenceConfig(device='cpu'),
                                               im_size=im_size)
    assert len(got.lines) == len(want.lines) > 40
    assert got.line_orders == want.line_orders
    assert len(got.line_orders) == len(seg.line_orders) + 1
    assert sorted(got.line_orders[-1]) == list(range(len(got.lines)))


def jax_golden() -> dict:
    """The JAX package's segmentation of the fixture page with the shipped
    segmenter and the reading-order fixture: its pair probabilities (the
    JAX ``neural_reading_order``'s features, forward and sigmoid) and its
    line orders."""
    from kraken_tpu.configs import SegmentationInferenceConfig
    from kraken_tpu.models import load_models
    from kraken_tpu.ro.features import element_features
    from kraken_tpu.tasks import SegmentationTaskModel
    ro = load_models(RO)[0]
    with warnings.catch_warnings():
        warnings.simplefilter('ignore')
        seg = SegmentationTaskModel(load_models(SEG) + [ro]).predict(
            Image.open(PAGE), SegmentationInferenceConfig())
    size = Image.open(PAGE).size
    num_classes = max(ro.class_mapping.values()) + 1
    feats = [element_features(line, size, ro.class_mapping, num_classes)[1] for line in seg.lines]
    n = len(feats)
    pairs = np.stack([np.concatenate([feats[i], feats[j]])
                      for i in range(n) for j in range(n) if i != j])
    probs = (1 / (1 + np.exp(-np.asarray(ro.forward(pairs))))).ravel()
    return {'page': PAGE.name, 'segmenter': SEG.name, 'reading_order_model': RO.name,
            'lines': n, 'line_orders': seg.line_orders,
            'pair_probabilities': [float(p) for p in probs]}


def test_golden_equals_a_fresh_jax_run():
    golden = json.loads(GOLDEN.read_text())
    fresh = jax_golden()
    assert {k: v for k, v in fresh.items() if k != 'pair_probabilities'} == \
        {k: v for k, v in golden.items() if k != 'pair_probabilities'}
    np.testing.assert_allclose(fresh['pair_probabilities'], golden['pair_probabilities'],
                               rtol=0, atol=1e-7)


def test_port_task_equals_golden():
    """The port's SegmentationTaskModel with both files on the CPU: the
    golden's line orders and pair probabilities within 1e-6 (as the card's
    run is held to them), the reading-order model on the segmenter's
    device."""
    from kraken_tpu_torch.configs import SegmentationInferenceConfig
    from kraken_tpu_torch.lib.geometry import pair_probabilities
    from kraken_tpu_torch.models import load_models
    from kraken_tpu_torch.tasks import SegmentationTaskModel
    golden = json.loads(GOLDEN.read_text())
    task = SegmentationTaskModel(load_models(SEG) + load_models(RO))
    im = Image.open(PAGE)
    seg = task.predict(im, SegmentationInferenceConfig(device='cpu'))
    assert seg.line_orders == golden['line_orders']
    ro = task.ro_models[0]
    assert ro.device == task.seg_models[0].device == torch.device('cpu')
    probs = pair_probabilities(seg.lines, im.size, ro, ro.class_mapping)
    np.testing.assert_allclose(probs, golden['pair_probabilities'], rtol=0, atol=1e-6)


def test_task_without_a_card_raises(monkeypatch):
    from kraken_tpu_torch.configs import SegmentationInferenceConfig
    from kraken_tpu_torch.models import load_models
    from kraken_tpu_torch.tasks import SegmentationTaskModel
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    task = SegmentationTaskModel(load_models(SEG) + load_models(RO))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        task.predict(Image.open(PAGE), SegmentationInferenceConfig())
    ro = load_models(RO)[0]
    with pytest.raises(RuntimeError, match='no CUDA device'):
        ro.prepare_for_inference(SegmentationInferenceConfig())
    assert ro.device.type == 'cpu'


def test_incompatible_class_mapping_raises_as_jax():
    from kraken_tpu.models import load_models as jax_load_models
    from kraken_tpu.tasks import SegmentationTaskModel as JaxTask
    from kraken_tpu_torch.models import load_models
    from kraken_tpu_torch.tasks import SegmentationTaskModel
    jm = jax_romlp(0, {'$other': 0})
    errors = []
    for task, models in ((JaxTask, jax_load_models(SEG) + [jm]),
                         (SegmentationTaskModel, load_models(SEG) + [port_copy(jm)])):
        with pytest.raises(ValueError) as err:
            task(models)
        errors.append(str(err.value))
    assert errors[0] == errors[1]


def test_cli_segment_with_ro_model_equals_jax(tmp_path):
    """`segment -bl -i blla_small.safetensors -i ro_small.safetensors` to
    JSON in both CLIs (the recipe of tests/test_cli.py:320)."""
    from tests.test_torch_cli import jax_run, normalise, page_args, torch_run
    outs = [run(page_args(tmp_path / f'{i}.json', 'segment', '-bl', '-i', SEG, '-i', RO),
                tmp_path / f'{i}.json') for i, run in enumerate((jax_run, torch_run))]
    seg = json.loads(outs[1])
    assert seg['line_orders'] and sorted(seg['line_orders'][-1]) == list(range(len(seg['lines'])))
    assert seg['line_orders'] == json.loads(GOLDEN.read_text())['line_orders']
    assert normalise(outs[1]) == normalise(outs[0])


def test_cli_show_prints_the_ro_model():
    """The JAX CLI stops on a reading-order model (it has no VGSL spec); the
    port prints what the JAX CLI printed before it stopped, then the
    model's level and class mapping."""
    from click.testing import CliRunner
    import kraken_tpu.kraken as jax_kraken
    from kraken_tpu_torch import kraken as torch_kraken
    jax_out = CliRunner().invoke(jax_kraken.cli, ['-d', 'cpu', 'show', str(RO)])
    assert isinstance(jax_out.exception, AttributeError)
    out = CliRunner().invoke(torch_kraken.cli, ['-d', 'cpu', 'show', str(RO)])
    assert out.exit_code == 0, out.output
    assert out.output.startswith(jax_out.output)
    assert 'level: baselines' in out.output and 'class mapping: default=0 $pag=1' in out.output


def test_pipeline_with_ro_model():
    """process_pages with a segmenter that carries the reading-order model."""
    from kraken_tpu_torch.configs import (RecognitionInferenceConfig,
                                          SegmentationInferenceConfig)
    from kraken_tpu_torch.models import load_models
    from kraken_tpu_torch.pipeline import process_pages
    from kraken_tpu_torch.tasks import SegmentationTaskModel
    golden = json.loads(GOLDEN.read_text())
    task = SegmentationTaskModel(load_models(SEG) + load_models(RO))
    rec = load_models(RESOURCES / 'overfit_bl.safetensors')[0]
    rec.prepare_for_inference(RecognitionInferenceConfig(device='cpu', num_line_workers=0))
    page = Image.open(PAGE)
    out = list(process_pages([page, page.copy()], rec, lambda im: task.predict(
        im, SegmentationInferenceConfig(device='cpu'))))
    assert len(out) == 2
    for _, seg, recs in out:
        assert seg.line_orders == golden['line_orders'] and len(recs) == len(seg.lines)


if __name__ == '__main__':
    GOLDEN.write_text(json.dumps(jax_golden()) + '\n')
    print(f'wrote {GOLDEN}')
