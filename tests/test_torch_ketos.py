"""
The port's ``ketos`` (kraken_tpu_torch.ketos) and the evaluation halves
of its training modules (kraken_tpu_torch.train) against the JAX package's
on the CPU (``-d cpu``; the port's default device is the card):

- ``ketos test``: the report is byte for byte the JAX CLI's (but that a
  confusion row names a space grapheme ``SPACE`` where the JAX package
  prints a blank, ROADMAP.md §3) for
  ``merge_codec_nfd.mlmodel`` on ``base.arrow`` (``-f binary``) and on the
  ``merge_tests`` path files. With ``overfit_bl.safetensors`` on the
  fixture PageXML (``-f xml``) the two forwards sum in other orders, so a
  decoded line may differ from the JAX package's only where the JAX
  softmax's two best classes lie within 1e-4 of each other at a frame of
  that line (the margin is printed); on this fixture every line, and so
  the report, is equal;
- ``segtest`` (``blla_small.safetensors`` on the fixture page): on the JAX
  network's own logits the port's evaluation gives JAX's
  ``val_accuracy``/``val_mean_iu`` within 1e-6 and equal baseline P/R/F1,
  and its ridge mask (``ops/ridge.py``) equals the JAX host filter's
  ``sato_ridge(...) > 0.17`` except at pixels whose JAX response lies
  within 1e-4 of 0.17 (their count is printed). End to end the port's own
  forward is the one within 1e-5 of a float64 forward (the JAX package's
  fp32 GroupNorm variance puts its heatmaps ~4e-4 from it), so there the
  metrics agree within 1e-5 (pixel metrics) and 1e-3 (P/R/F1);
- ``convert``: a JAX checkpoint (``save_checkpoint`` with optimizer state)
  converts to safetensors and CoreML files that load in both packages with
  bit-equal parameters; ``roadd``: ``ro_small`` embedded in the shipped
  segmenter gives the neural order of ``torch_ro_golden.json``;
  ``compile``: the JAX CLI's rows;
- ``--device`` defaults to ``cuda`` (a usage error without a card);
  ``train``/``segtrain``/``rotrain`` train an epoch on the CPU and write a
  best model both packages load, ``pretrain`` is a usage error only
  without data or a card, and ``setup('fit')`` builds a differentiable
  ``loss_fn``.
"""
from tests.test_torch_threads import subprocess_env  # first: the thread share under xdist
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch
from click.testing import CliRunner

RESOURCES = Path(__file__).resolve().parent / 'resources'
MERGE = RESOURCES / 'merge_tests'
MERGE_MODEL = MERGE / 'merge_codec_nfd.mlmodel'
PATH_LINES = [MERGE / f'{n}.jpg' for n in ('0006', '0007', '0008', '0021')]
PAGE_XML = RESOURCES / '170025120000003,0074.xml'
SEG_MODEL = RESOURCES / 'blla_small.safetensors'
# a decoded line may differ from JAX's only at a frame whose two best
# softmax classes lie within this of each other
ARGMAX_MARGIN = 1e-4
# segtest on the same heatmaps, and end to end (module docstring)
PIXEL_ATOL = 1e-6
RIDGE_NEAR = 1e-4
E2E_PIXEL_ATOL = 1e-5
E2E_BL_ATOL = 1e-3


def port_cli(args: list, **kwargs):
    from kraken_tpu_torch.ketos import cli
    result = CliRunner().invoke(cli, [str(a) for a in args], **kwargs)
    return result


def jax_cli(args: list):
    from kraken_tpu.ketos import cli
    result = CliRunner().invoke(cli, [str(a) for a in args])
    assert result.exit_code == 0, result.output
    return result


def space_named(report: str) -> str:
    """The JAX package's ``ketos test`` report as the port writes it: a
    confusion row names a space grapheme ``SPACE`` where the JAX package
    prints a blank (ROADMAP.md §3); every other character stays."""
    head, sep, rows = report.partition('Errors\tCorrect-Generated\n')
    return head + sep + re.sub(r'(?<=\{ ) (?= \})', 'SPACE', rows)


def ok(result):
    assert result.exit_code == 0, (result.output, result.exception)
    return result


@pytest.mark.parametrize('command', [[], ['test'], ['segtest'], ['convert'], ['roadd'],
                                     ['compile'], ['publish']])
def test_help(command):
    assert 'Usage' in ok(port_cli(command + ['--help'])).output


def test_group_offers_the_commands():
    from kraken_tpu_torch.ketos import cli
    assert set(cli.commands) == {'test', 'segtest', 'convert', 'roadd', 'compile',
                                 'train', 'segtrain', 'rotrain', 'pretrain', 'publish'}


@pytest.mark.parametrize('command, item', [('pretrain', '11')])
def test_training_commands_are_usage_errors(command, item, monkeypatch):
    """``pretrain``, a usage error until ROADMAP.md queue 1 item 11 landed,
    is one now only as the other training commands are: without data, and
    without a card unless the run asks for the CPU."""
    result = port_cli(['-d', 'cpu', command, '-f', 'binary', '--epochs', '3'])
    assert result.exit_code == 2 and 'No training data provided' in result.output
    assert f'item {item}' not in result.output
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    result = port_cli([command, '-f', 'binary', '--epochs', '3', MERGE / 'base.arrow'])
    assert result.exit_code == 2 and 'none is available' in result.output


@pytest.mark.parametrize('command, args', [
    ('train', ['-f', 'path', '-s', '[1,32,0,1 Cr3,3,4,2,2 S1(1x0)1,3 Lbx8 Do0.1,2]',
               *PATH_LINES]),
    ('segtrain', ['-s', '[1,64,0,3 Cr3,3,4,2,2 Gn2]', PAGE_XML]),
    ('rotrain', [PAGE_XML])], ids=['train', 'segtrain', 'rotrain'])
def test_training_commands_run_an_epoch(command, args, tmp_path):
    """Each training command trains one epoch on the CPU and writes its
    checkpoints, the best of which loads as a model in both packages."""
    from kraken_tpu.models import load_models as jax_load_models
    from kraken_tpu_torch.models import load_models
    ok(port_cli(['-d', 'cpu', '-s', '1', command, '-N', '1', '-o', tmp_path / 'm', *args]))
    best = tmp_path / 'm_best.safetensors'
    assert (tmp_path / 'm_0.safetensors').exists() and best.exists()
    assert load_models(best) and jax_load_models(best)


@pytest.mark.parametrize('args', [['test', '-m', MERGE_MODEL, *PATH_LINES],
                                  ['segtest', '-m', SEG_MODEL, PAGE_XML]], ids=['test', 'segtest'])
def test_device_defaults_to_the_card(args, monkeypatch):
    """The commands that run a model default to the card and stop with a
    usage error without one."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    result = port_cli(args)
    assert result.exit_code == 2
    assert '--device cuda asks for a CUDA card' in result.output and '--device cpu' in result.output


def test_fit_setup_builds_a_loss_fn():
    """setup('fit') of the recognition and segmentation modules builds the
    network from the training data and a loss_fn whose loss is finite and
    differentiable."""
    from kraken_tpu_torch.configs import (RecognitionTrainingConfig, RecognitionTrainingDataConfig,
                                          SegmentationTrainingConfig,
                                          SegmentationTrainingDataConfig)
    from kraken_tpu_torch.train import (RecognitionDataModule, RecognitionModel,
                                        SegmentationDataModule, SegmentationModel)
    cases = [(RecognitionDataModule(RecognitionTrainingDataConfig(
                  format_type='path', training_data=PATH_LINES[:3], evaluation_data=PATH_LINES[3:])),
              RecognitionModel(RecognitionTrainingConfig(
                  device='cpu', spec='[1,32,0,1 Cr3,3,4,2,2 S1(1x0)1,3 Lbx8]'))),
             (SegmentationDataModule(SegmentationTrainingDataConfig(
                  training_data=[PAGE_XML], evaluation_data=[PAGE_XML])),
              SegmentationModel(SegmentationTrainingConfig(
                  device='cpu', spec='[1,64,0,3 Cr3,3,4,2,2 Gn2]')))]
    for dm, module in cases:
        for stage in ('fit', None):
            dm.setup(stage)
        module.setup('fit', dm)
        loss = module.loss_fn(next(iter(dm.train_dataloader())))
        loss.backward()
        assert torch.isfinite(loss)
        assert all(p.grad is not None for p in module.parameters())


@pytest.mark.parametrize('inputs', [['-f', 'binary', MERGE / 'base.arrow'], PATH_LINES],
                         ids=['binary', 'path'])
def test_report_equals_jax(inputs):
    args = ['test', '-m', MERGE_MODEL, *inputs]
    ours = ok(port_cli(['-d', 'cpu'] + args)).output
    assert ours.startswith(f'=== report {MERGE_MODEL} ===') and 'Character Accuracy' in ours
    assert '{ SPACE }' in ours
    assert ours == space_named(jax_cli(['-d', 'cpu'] + args).output)


def decoded_lines(package: str, model_path, files, format_type):
    """Per line of the test set: (prediction, target, smallest top-two
    softmax margin over the line's frames), decoded by `package`'s
    evaluation module."""
    if package == 'jax':
        from kraken_tpu import configs
        from kraken_tpu.train import RecognitionDataModule, RecognitionModel
    else:
        from kraken_tpu_torch import configs
        from kraken_tpu_torch.train import RecognitionDataModule, RecognitionModel
    module = RecognitionModel.load_from_weights(configs.RecognitionTrainingConfig(device='cpu'),
                                                model_path)
    data = configs.RecognitionTrainingDataConfig(test_data=files, format_type=format_type,
                                                 batch_size=8)
    data.legacy_polygons = module.net.use_legacy_polygons
    dm = RecognitionDataModule(data)
    dm.setup('test')
    module.setup('test', dm)
    if package == 'jax':
        metrics = module.test(module.net.params, dm)
    else:
        metrics = module.test(dm)
    codec = module.net.codec.add_labels(set(dm.test_set.dataset.alphabet)
                                        - set(module.net.codec.c2l))
    out = []
    for batch in dm.test_dataloader():
        if package == 'jax':
            preds = module._decode_batch(module.net.params, batch, codec)
            probs, olens = module._fwd(module.net.params, batch['image'], batch['seq_lens'])
            probs, olens = np.asarray(probs), np.asarray(olens)
        else:
            preds = module._decode_batch(batch, codec)
            olens = None
        targets = module._decode_targets(batch, codec)
        for i, (p, t) in enumerate(zip(preds, targets)):
            margin = None
            if olens is not None:
                top2 = np.sort(probs[i, :, :int(olens[i])], axis=0)[-2:]
                margin = float((top2[1] - top2[0]).min()) if top2.shape[1] else np.inf
            out.append((p, t, margin))
    return out, metrics


def test_xml_lines_equal_jax():
    """``overfit_bl.safetensors`` on the fixture PageXML: the decoded lines
    equal the JAX package's but where the JAX margin is under 1e-4, and
    the character count equals."""
    ours, our_metrics = decoded_lines('port', RESOURCES / 'overfit_bl.safetensors', [PAGE_XML],
                                      'xml')
    theirs, their_metrics = decoded_lines('jax', RESOURCES / 'overfit_bl.safetensors',
                                          [PAGE_XML], 'xml')
    assert len(ours) == len(theirs) == 44
    assert [t for _, t, _ in ours] == [t for _, t, _ in theirs]
    differ = [(i, m) for i, ((p, _, _), (q, _, m)) in enumerate(zip(ours, theirs)) if p != q]
    print(f'{len(ours) - len(differ)} of {len(ours)} lines decoded alike; differing lines and '
          f'their smallest JAX argmax margin: {differ}')
    assert all(m < ARGMAX_MARGIN for _, m in differ)
    assert our_metrics['chars'] == their_metrics['chars']
    if not differ:
        assert {k: v for k, v in our_metrics.items()} == their_metrics


def test_xml_report_equals_jax():
    args = ['test', '-f', 'xml', '-m', RESOURCES / 'overfit_bl.safetensors', PAGE_XML]
    ours = ok(port_cli(['-d', 'cpu'] + args)).output
    assert '{ SPACE }' in ours
    assert ours == space_named(jax_cli(['-d', 'cpu'] + args).output)


@pytest.fixture(scope='module')
def segtest_modules():
    """Both packages' segmentation modules, set up for the fixture page."""
    from kraken_tpu import configs as jc
    from kraken_tpu.train import SegmentationDataModule as JaxDM, SegmentationModel as JaxModel
    from kraken_tpu_torch import configs as tc
    from kraken_tpu_torch.train import SegmentationDataModule, SegmentationModel
    out = []
    for configs, dm_cls, model_cls in ((jc, JaxDM, JaxModel),
                                       (tc, SegmentationDataModule, SegmentationModel)):
        module = model_cls.load_from_weights(configs.SegmentationTrainingConfig(device='cpu'),
                                             SEG_MODEL)
        cm = module.net.user_metadata['class_mapping']
        dm = dm_cls(configs.SegmentationTrainingDataConfig(
            test_data=[PAGE_XML], line_class_mapping=cm['baselines'],
            region_class_mapping=cm['regions']))
        dm.setup('test')
        dm.val_set = dm.test_set
        module.setup('test', dm)
        out.append((module, dm))
    return out


class _Logits(torch.nn.Module):
    """A network stand-in returning fixed logits."""

    def __init__(self, logits: np.ndarray):
        super().__init__()
        self.logits = torch.from_numpy(np.array(logits))

    def forward(self, x, seq_len=None, output_shape=None):
        return self.logits, None


def test_segtest_on_jax_heatmaps_equals_jax(segtest_modules):
    """The port's evaluation (sigmoid, resize, ridge kernel's plain
    version, vectorizer, metrics) on the JAX network's logits: JAX's
    metrics, and JAX's ridge mask but at near-threshold pixels."""
    import jax
    import jax.numpy as jnp
    from kraken_tpu.lib.vectorization import sato_ridge
    (jax_module, jax_dm), (port_module, port_dm) = segtest_modules
    theirs = jax_module.validate(jax_module.net.params, jax_dm)
    batch = next(iter(port_dm.val_dataloader()))
    logits = np.asarray(jax_module.net.net.apply(jax_module.net.params,
                                                 jnp.asarray(batch['image']), None)[0])
    net = port_module.net.net
    port_module.net.net = _Logits(logits)
    try:
        ours = port_module.validate(port_dm)
        channels = tuple(sorted(port_module.net.user_metadata['class_mapping']['baselines']
                                .values()))
        _, bins = port_module._forward(batch['image'], batch['target'].shape[2:], channels)
    finally:
        port_module.net.net = net
    assert sorted(ours) == sorted(theirs)
    for k in ('val_accuracy', 'val_mean_iu', 'val_metric'):
        assert abs(ours[k] - theirs[k]) <= PIXEL_ATOL, k
    for k in ('val_bl_precision', 'val_bl_recall', 'val_bl_f1'):
        assert ours[k] == theirs[k], k
    jax_probs = np.asarray(jax_module._fwd(jax_module.net.params, jnp.asarray(batch['image'])))
    jax_full = np.asarray(jax.image.resize(jnp.asarray(jax_probs), batch['target'].shape,
                                           method='bilinear'))
    near = flips = 0
    for i, c in enumerate(channels):
        response = sato_ridge(jax_full[0, c])
        close = np.abs(response - 0.17) < RIDGE_NEAR
        flipped = bins[0, i] != (response > 0.17)
        near += int(close.sum())
        flips += int(flipped.sum())
        assert not (flipped & ~close).any(), c
    print(f'ridge masks: {flips} pixels differ from the JAX host filter, all among the '
          f'{near} whose JAX response lies within {RIDGE_NEAR:g} of 0.17')


def test_segtest_forward_is_the_float64_one(segtest_modules):
    """The port's float32 forward lies within 1e-5 of a float64 forward
    of the same network; the JAX package's within 1e-3 (its GroupNorm sums
    the variance in fp32 in one pass). So end to end the metrics differ
    from JAX's within 1e-5 (pixel metrics) and 1e-3 (P/R/F1)."""
    import jax.numpy as jnp
    (jax_module, _), (port_module, port_dm) = segtest_modules
    batch = next(iter(port_dm.val_dataloader()))
    x = torch.from_numpy(batch['image'])
    net = port_module.net.net
    with torch.no_grad():
        ours = torch.sigmoid(net(x, None)[0])
        try:
            exact = torch.sigmoid(net.double()(x.double(), None)[0])
        finally:
            net.float()
    theirs = np.asarray(jax_module._fwd(jax_module.net.params, jnp.asarray(batch['image'])))
    ours_err = float((ours.double() - exact).abs().max())
    theirs_err = float(np.abs(theirs - exact.numpy()).max())
    print(f'sigmoid heatmaps from a float64 forward: port {ours_err:.3g}, JAX {theirs_err:.3g}')
    assert ours_err < 1e-5 and theirs_err < 1e-3
    jax_dm = segtest_modules[0][1]
    ours, theirs = port_module.validate(port_dm), jax_module.validate(jax_module.net.params, jax_dm)
    diff = {k: abs(ours[k] - theirs[k]) for k in ours}
    print(f'segtest metrics end to end, port against JAX: {diff}')
    for k, d in diff.items():
        assert d <= (E2E_BL_ATOL if '_bl_' in k else E2E_PIXEL_ATOL), k


def test_segtest_cli_equals_jax_within_the_forward():
    args = ['segtest', '-m', SEG_MODEL, PAGE_XML]
    ours = ok(port_cli(['-d', 'cpu'] + args)).output
    theirs = jax_cli(['-d', 'cpu'] + args).output

    def values(text):
        return {k: float(v) for k, v in (line.split(': ') for line in text.splitlines()
                                         if ': ' in line)}
    a, b = values(ours), values(theirs)
    assert ours.splitlines()[0] == theirs.splitlines()[0] == f'=== {SEG_MODEL} ==='
    assert sorted(a) == sorted(b) and len(a) == 6
    for k in a:
        # the printed values are rounded to 4 digits
        tol = (E2E_BL_ATOL if '_bl_' in k else E2E_PIXEL_ATOL) + 5e-5
        assert abs(a[k] - b[k]) <= tol, k


def jax_checkpoint(path):
    """A JAX training checkpoint of overfit_bl with Adam state."""
    import optax
    from kraken_tpu.models import load_models
    from kraken_tpu.train import save_checkpoint
    model = load_models(RESOURCES / 'overfit_bl.safetensors')[0]
    save_checkpoint(model, optax.adam(1e-3).init(model.params), path, epoch=3, global_step=17,
                    hyper_params={'lrate': 1e-3})
    return model


@pytest.mark.parametrize('fmt, suffix', [('safetensors', 'safetensors'), ('coreml', 'mlmodel')])
def test_convert_jax_checkpoint(fmt, suffix, tmp_path):
    from kraken_tpu.models import load_models as jax_load
    from kraken_tpu_torch.models import load_models
    from kraken_tpu_torch.models._safetensors import read_safetensors
    model = jax_checkpoint(tmp_path / 'ckpt.safetensors')
    assert any(k.startswith('__training__.opt.') for k in
               read_safetensors(tmp_path / 'ckpt.safetensors')[1])
    out = tmp_path / f'model.{suffix}'
    ok(port_cli(['-d', 'cpu', 'convert', '--weights-format', fmt, '-o', out,
                 tmp_path / 'ckpt.safetensors']))
    if fmt == 'safetensors':
        meta, tensors = read_safetensors(out)
        assert list(meta) == ['kraken_meta'] and not any('__training__' in k for k in tensors)
    ref = model.state_dict()
    for loaded in (jax_load(out)[0], load_models(out)[0]):
        assert loaded.spec == model.spec and loaded.codec.c2l == model.codec.c2l
        sd = {k: np.asarray(v) for k, v in loaded.state_dict().items()}
        assert sorted(sd) == sorted(ref) and all(np.array_equal(sd[k], ref[k]) for k in ref)


def test_roadd_gives_the_golden_order(tmp_path):
    from PIL import Image
    from kraken_tpu.models import load_models as jax_load
    from kraken_tpu_torch.configs import SegmentationInferenceConfig
    from kraken_tpu_torch.lib.util import default_segmentation_model
    from kraken_tpu_torch.models import load_models
    from kraken_tpu_torch.tasks import SegmentationTaskModel
    out = tmp_path / 'combined.safetensors'
    ok(port_cli(['-d', 'cpu', 'roadd', '-o', out, '-i', default_segmentation_model(),
                 '-r', RESOURCES / 'ro_small.safetensors']))
    models = load_models(out)
    assert [type(m).__name__ for m in models] == ['VGSLModel', 'ROMLP']
    assert [type(m).__name__ for m in jax_load(out)] == ['VGSLModel', 'ROMLP']
    golden = json.loads((RESOURCES / 'torch_ro_golden.json').read_text())
    seg = SegmentationTaskModel(models).predict(Image.open(RESOURCES / golden['page']),
                                                SegmentationInferenceConfig(device='cpu'))
    assert len(seg.lines) == golden['lines'] and seg.line_orders == golden['line_orders']


def test_roadd_refuses_a_file_without_ro_model(tmp_path):
    result = port_cli(['-d', 'cpu', 'roadd', '-o', tmp_path / 'x.safetensors', '-i', SEG_MODEL,
                       '-r', SEG_MODEL])
    assert result.exit_code == 2 and 'No reading order model' in result.output


def test_compile_cli_equals_jax(tmp_path):
    import pyarrow as pa

    def rows(path):
        with pa.memory_map(str(path), 'rb') as source:
            table = pa.ipc.open_file(source).read_all()
        return table.schema.metadata, table.to_pylist()
    ok(port_cli(['-d', 'cpu', 'compile', '-f', 'path', '-o', tmp_path / 'port.arrow',
                 *PATH_LINES]))
    jax_cli(['compile', '-f', 'path', '-o', tmp_path / 'jax.arrow', *PATH_LINES])
    assert rows(tmp_path / 'port.arrow') == rows(tmp_path / 'jax.arrow')


@pytest.mark.parametrize('mapping', [{'a': 2, 'b': 3}, [['a', 2], ['b', 3]],
                                     [['a', 2], ['*', 7]]])
def test_create_class_map_equals_jax(mapping):
    from kraken_tpu.ketos.util import create_class_map as jax_map
    from kraken_tpu_torch.ketos.util import create_class_map
    ours, theirs = create_class_map(mapping), jax_map(mapping)
    assert dict(ours) == dict(theirs) and ours.get('zz') == theirs.get('zz')
    if '*' in str(mapping):
        assert ours['zz'] == theirs['zz'] == 7


_NO_LXML = """
import sys
class _Block:
    def find_spec(self, name, path=None, target=None):
        if name.split('.')[0] == 'lxml':
            raise ImportError('lxml is blocked')
sys.meta_path.insert(0, _Block())
from kraken_tpu_torch.ketos import cli
merge, out = sys.argv[1], sys.argv[2]
for args in (['test', '-m', merge + '/merge_codec_nfd.mlmodel', merge + '/0006.jpg'],
             ['test', '-m', merge + '/merge_codec_nfd.mlmodel', '-f', 'binary',
              merge + '/base.arrow'],
             ['compile', '-f', 'path', '-o', out, merge + '/0006.jpg', merge + '/0007.jpg'],
             ['convert', '-o', out + '.safetensors', merge + '/merge_codec_nfd.mlmodel']):
    cli.main(['-d', 'cpu'] + args, standalone_mode=False)
print('LXML', sorted(m for m in sys.modules if m.startswith('lxml')))
"""


def test_ketos_runs_without_lxml(tmp_path):
    """``ketos test`` on path and binary input, ``compile -f path`` and
    ``convert`` need no lxml (the card's machine has none)."""
    import subprocess
    import sys
    out = subprocess.run([sys.executable, '-c', _NO_LXML, str(MERGE), str(tmp_path / 'ds.arrow')],
                         cwd=RESOURCES.parent.parent, capture_output=True, text=True, timeout=300,
                         env=subprocess_env())
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.count('=== report') == 2 and 'LXML []' in out.stdout
