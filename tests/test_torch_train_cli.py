"""
The port's training commands through its ``ketos`` CLI on the CPU (``-d
cpu``): the JAX package's ``tests/test_cli.py`` cases of ``segtrain``,
``rotrain`` and ``train`` (YAML experiment files, class mappings, a
reading-order model added to a segmentation model), and checkpoints
written by either package loading as models in the other.
"""
import tests.test_torch_threads  # noqa: F401  (first: the thread share under xdist)
import json
from pathlib import Path

import pytest
from click.testing import CliRunner

RESOURCES = Path(__file__).resolve().parent / 'resources'
PAGE_XML = RESOURCES / '170025120000003,0074.xml'
TINY_SEG_SPEC = '[1,64,0,3 Cr3,3,4,2,2 Gn2]'
TINY_REC_SPEC = '[1,32,0,1 Cr3,3,4,2,2 S1(1x0)1,3 Lbx8 Do0.1,2]'


def ketos(*args):
    from kraken_tpu_torch.ketos import cli
    result = CliRunner().invoke(cli, ['-d', 'cpu', *(str(a) for a in args)])
    assert result.exit_code == 0, (result.output, result.exception)
    return result


def test_segtrain_then_segtest(tmp_path):
    ketos('segtrain', '-N', '1', '-o', tmp_path / 'seg', '-s', TINY_SEG_SPEC, PAGE_XML)
    best = tmp_path / 'seg_best.safetensors'
    assert list(tmp_path.glob('seg_*.safetensors')) and best.exists()
    assert 'val_mean_iu' in ketos('segtest', '-m', best, PAGE_XML).output


def test_rotrain_then_roadd(tmp_path):
    ketos('-s', '42', 'rotrain', '-N', '1', '-o', tmp_path / 'ro', PAGE_XML)
    ro_best = tmp_path / 'ro_best.safetensors'
    assert ro_best.exists()
    ketos('roadd', '-i', RESOURCES / 'blla_small.safetensors', '-r', ro_best,
          '-o', tmp_path / 'seg_ro.safetensors')
    from kraken_tpu.models import load_models as jax_load_models
    from kraken_tpu_torch.models import load_models
    for load in (load_models, jax_load_models):
        models = load(tmp_path / 'seg_ro.safetensors')
        assert any('reading_order' in getattr(m, 'model_type', []) for m in models)


def test_yaml_experiment_file(tmp_path):
    cfg = tmp_path / 'exp.yml'
    cfg.write_text('train:\n  epochs: 1\n  lrate: 0.002\n'
                   f"  spec: '{TINY_REC_SPEC}'\n  format_type: binary\n")
    from kraken_tpu_torch.ketos import cli
    for args in (['-d', 'cpu', 'train', '--config', str(cfg)],
                 ['-d', 'cpu', '--config', str(cfg), 'train']):
        out = tmp_path / f'm{len(args)}'
        result = CliRunner().invoke(cli, args + ['-o', str(out),
                                                 str(RESOURCES / 'merge_tests' / 'base.arrow')])
        assert result.exit_code == 0, result.output
        assert list(tmp_path.glob(f'{out.name}_*.safetensors')), result.output


def test_segtrain_class_mapping_config(tmp_path):
    import yaml
    cfg = tmp_path / 'exp.yaml'
    cfg.write_text(yaml.safe_dump({
        'segtrain': {'line_class_mapping': [['default', 2], ['*', 2]],
                     'region_class_mapping': [['*', 3]]}}))
    ketos('segtrain', '--config', cfg, '-N', '1', '-o', tmp_path / 'seg', '-s', TINY_SEG_SPEC,
          PAGE_XML)
    from kraken_tpu_torch.models import load_models
    cm = load_models(tmp_path / 'seg_best.safetensors')[0].user_metadata['class_mapping']
    assert set(cm['baselines'].values()) == {2}
    assert set(cm['regions'].values()) == {3}


def test_rotrain_class_mapping_from_ckpt(tmp_path):
    ketos('segtrain', '-N', '1', '-o', tmp_path / 'seg', '-s', TINY_SEG_SPEC, PAGE_XML)
    ketos('rotrain', '-N', '1', '-o', tmp_path / 'ro', '--class-mapping-from-ckpt',
          tmp_path / 'seg_0.safetensors', PAGE_XML)
    assert (tmp_path / 'ro_best.safetensors').exists()


@pytest.mark.parametrize('fmt', ['safetensors', 'coreml'])
def test_train_writes_the_best_model(tmp_path, fmt):
    """``train`` converts its best checkpoint to a weights file in the
    asked format (the JAX CLI's ``_best`` model), which both packages
    load with the same codec."""
    ketos('-s', '3', 'train', '-N', '1', '-f', 'binary', '-s', TINY_REC_SPEC,
          '--weights-format', fmt, '-o', tmp_path / 'm',
          RESOURCES / 'merge_tests' / 'base.arrow')
    out = tmp_path / ('m_best.mlmodel' if fmt == 'coreml' else 'm_best.safetensors')
    from kraken_tpu.models import load_models as jax_load_models
    from kraken_tpu_torch.models import load_models
    port, jax = load_models(out)[0], jax_load_models(out)[0]
    assert port.codec.c2l == jax.codec.c2l and port.spec == jax.spec


def test_jax_checkpoints_load_in_the_port(tmp_path):
    """A checkpoint of the JAX package's segtrain loads in the port as a
    model with the same parameters and metadata."""
    import numpy as np
    from kraken_tpu.ketos import cli as jax_cli
    result = CliRunner().invoke(jax_cli, ['segtrain', '-N', '1', '-o', str(tmp_path / 'j'),
                                          '-s', TINY_SEG_SPEC, str(PAGE_XML)])
    assert result.exit_code == 0, result.output
    from kraken_tpu.models import load_models as jax_load_models
    from kraken_tpu_torch.models import load_models
    ckpt = tmp_path / 'j_best.safetensors'
    port, jax = load_models(ckpt)[0], jax_load_models(ckpt)[0]
    sd = jax.state_dict()
    for k, v in port.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k])
    assert json.dumps(port.user_metadata['class_mapping'], sort_keys=True) == \
        json.dumps(jax.user_metadata['class_mapping'], sort_keys=True)
