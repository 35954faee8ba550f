"""
The port's model writers (kraken_tpu_torch.models.writers and
._coreml_writer) and its model surgery (``VGSLModel.append`` and
``resize_output``) against the JAX package on the CPU:

- a file the port writes (safetensors or CoreML) from the recognition,
  segmentation, ocropy, transformer and reading-order fixtures loads in
  the JAX package with the metadata and the parameters (bit for bit) the
  port holds, and a file the JAX package writes loads in the port so;
- the port's CoreML bytes equal the JAX writer's for the same model (the
  JAX CoreML writer is deterministic: it writes no uuid and no time);
  safetensors files differ only by their random per-model key prefixes;
- a model CoreML cannot hold (a ``Te`` block, a file of reading-order
  models only) raises the JAX writer's ValueError;
- ``append`` and ``resize_output`` give the JAX package's specs, output
  shapes and parameter shapes, and keep the surviving rows bit for bit.
"""
import tests.test_torch_threads  # noqa: F401  (first: the thread share under xdist)
from pathlib import Path

import numpy as np
import pytest
import torch

RESOURCES = Path(__file__).resolve().parent / 'resources'
FIXTURES = ['overfit.mlmodel', 'overfit_bl.safetensors', 'ocropy_small.mlmodel',
            'te_small.safetensors', 'ro_small.safetensors', 'blla_small.safetensors']
# fixtures whose models a CoreML file cannot hold, with the JAX writer's error
NO_COREML = {'te_small.safetensors': 'Cannot serialize layer TransformerEncoder',
             'ro_small.safetensors': 'exactly one VGSL model'}


def jax_models(path):
    from kraken_tpu.models import load_models
    return load_models(path)


def port_models(path):
    from kraken_tpu_torch.models import load_models
    return load_models(path)


def port_arrays(model) -> dict:
    """A model's parameters as numpy arrays (a port model's tensors or a
    JAX model's arrays)."""
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in model.state_dict().items()}


def assert_same_models(jax_list, port_list):
    """Equal model classes, metadata and parameters (bit for bit)."""
    assert [type(m).__name__ for m in jax_list] == [type(m).__name__ for m in port_list]
    for j, p in zip(jax_list, port_list):
        assert j.user_metadata == p.user_metadata
        if hasattr(j, 'spec'):
            assert j.spec == p.spec
            assert (j.codec.c2l if j.codec else None) == (p.codec.c2l if p.codec else None)
        js, ps = j.state_dict(), port_arrays(p)
        assert sorted(js) == sorted(ps)
        for k in js:
            assert np.asarray(js[k]).dtype == ps[k].dtype, k
            assert np.array_equal(np.asarray(js[k]), ps[k]), k


@pytest.mark.parametrize('fmt', ['safetensors', 'coreml'])
@pytest.mark.parametrize('fixture', FIXTURES)
def test_port_file_loads_in_jax(fixture, fmt, tmp_path):
    from kraken_tpu_torch.models import write_models
    port = port_models(RESOURCES / fixture)
    out = tmp_path / f'model.{fmt}'
    if fmt == 'coreml' and fixture in NO_COREML:
        with pytest.raises(ValueError, match=NO_COREML[fixture]):
            write_models(port, out, format=fmt)
        return
    write_models(port, out, format=fmt)
    assert_same_models(jax_models(out), port)
    assert_same_models(jax_models(out), port_models(out))


@pytest.mark.parametrize('fmt', ['safetensors', 'coreml'])
@pytest.mark.parametrize('fixture', FIXTURES)
def test_jax_file_loads_in_port(fixture, fmt, tmp_path):
    from kraken_tpu.models import write_models
    jax = jax_models(RESOURCES / fixture)
    out = tmp_path / f'model.{fmt}'
    if fmt == 'coreml' and fixture in NO_COREML:
        with pytest.raises(ValueError, match=NO_COREML[fixture]):
            write_models(jax, out, format=fmt)
        return
    write_models(jax, out, format=fmt)
    assert_same_models(jax, port_models(out))


@pytest.mark.parametrize('fixture', [f for f in FIXTURES if f not in NO_COREML])
def test_coreml_bytes_equal_jax(fixture, tmp_path):
    from kraken_tpu.models import write_models as jax_write
    from kraken_tpu_torch.models import write_models as port_write
    port_write(port_models(RESOURCES / fixture), tmp_path / 'port.mlmodel', format='coreml')
    jax_write(jax_models(RESOURCES / fixture), tmp_path / 'jax.mlmodel', format='coreml')
    assert (tmp_path / 'port.mlmodel').read_bytes() == (tmp_path / 'jax.mlmodel').read_bytes()


def test_segmenter_with_ro_model_in_coreml(tmp_path):
    """A segmenter and a reading-order model of its class mapping in one
    CoreML file: the JAX writer's bytes, and both packages load both
    models with the port's parameters."""
    import jax.numpy as jnp
    from kraken_tpu.models import write_models as jax_write
    from kraken_tpu.ro.layers import ROMLP as JaxROMLP
    from kraken_tpu_torch.models import write_models as port_write
    from kraken_tpu_torch.ro import ROMLP
    seg = port_models(RESOURCES / 'blla_small.safetensors')[0]
    meta = {'class_mapping': seg.user_metadata['class_mapping']['baselines'],
            'level': 'baselines'}
    ro = ROMLP(generator=torch.Generator().manual_seed(1), **meta)
    jax_ro = JaxROMLP(**meta)
    jax_ro.params = {k[3:]: jnp.asarray(v) for k, v in port_arrays(ro).items()}
    port_write([seg, ro], tmp_path / 'port.mlmodel', format='coreml')
    jax_write(jax_models(RESOURCES / 'blla_small.safetensors') + [jax_ro],
              tmp_path / 'jax.mlmodel', format='coreml')
    assert (tmp_path / 'port.mlmodel').read_bytes() == (tmp_path / 'jax.mlmodel').read_bytes()
    for loaded in (port_models(tmp_path / 'port.mlmodel'), jax_models(tmp_path / 'port.mlmodel')):
        assert [type(m).__name__ for m in loaded] == ['VGSLModel', 'ROMLP']
        for a, b in zip((seg, ro), loaded):
            ours, theirs = port_arrays(a), port_arrays(b)
            assert sorted(ours) == sorted(theirs)
            assert all(np.array_equal(ours[k], theirs[k]) for k in ours)


def test_safetensors_reads_with_the_safetensors_package(tmp_path):
    """The port's own safetensors writer makes a file the ``safetensors``
    package reads: its tensors, its metadata."""
    from safetensors import safe_open
    from kraken_tpu_torch.models._safetensors import read_safetensors, write_safetensors
    rng = np.random.RandomState(0)
    tensors = {'b.w': rng.rand(3, 5).astype(np.float32), 'a': rng.randint(0, 9, 7),
               'c': rng.rand(2).astype(np.float16), 'd': np.zeros((0, 4), np.float32)}
    write_safetensors(tmp_path / 'x.safetensors', tensors, {'k': 'v'})
    with safe_open(tmp_path / 'x.safetensors', framework='np') as f:
        assert f.metadata() == {'k': 'v'}
        assert sorted(f.keys()) == sorted(tensors)
        for k in tensors:
            assert np.array_equal(f.get_tensor(k), tensors[k])
    meta, back = read_safetensors(tmp_path / 'x.safetensors')
    assert meta == {'k': 'v'} and all(np.array_equal(back[k], tensors[k]) for k in tensors)


def test_bf16_model_is_written_in_float32(tmp_path):
    """A model cast to bfloat16 writes float32 parameters (the bf16
    values, widened)."""
    from kraken_tpu_torch.models import write_models
    model = port_models(RESOURCES / 'overfit.mlmodel')[0]
    model.net.to(torch.bfloat16)
    write_models([model], tmp_path / 'bf16.safetensors')
    loaded = jax_models(tmp_path / 'bf16.safetensors')[0].state_dict()
    for k, v in model.state_dict().items():
        assert loaded[k].dtype == np.float32
        assert np.array_equal(loaded[k], v.to(torch.float32).numpy())


# (fixture, idx, spec): the recognizer cut after its reshape with a new
# BiLSTM and output, cut before its output, and the segmenter's head swapped
APPEND_CASES = [('overfit.mlmodel', 5, '[Lbx32 O1c40]'),
                ('overfit.mlmodel', 4, '[Cr3,3,16 S1(1x0)1,3 Lbx8 O1c10]'),
                ('blla_small.safetensors', 10, '[Cr3,3,32 O2l6]')]


@pytest.mark.parametrize('fixture, idx, spec', APPEND_CASES)
def test_append_equals_jax(fixture, idx, spec):
    jax, port = jax_models(RESOURCES / fixture)[0], port_models(RESOURCES / fixture)[0]
    before = port_arrays(port)
    jax.append(idx, spec)
    port.append(idx, spec, generator=torch.Generator().manual_seed(3))
    assert port.spec == jax.spec and port.user_metadata['vgsl'] == jax.user_metadata['vgsl']
    assert port.output == jax.output and port.criterion == jax.criterion
    after, js = port_arrays(port), jax.state_dict()
    assert {k: v.shape for k, v in after.items()} == {k: np.asarray(v).shape for k, v in js.items()}
    kept = [k for k in after if k in before]
    assert kept and all(np.array_equal(after[k], before[k]) for k in kept)
    with torch.no_grad():
        y, _ = port(torch.rand(1, port.input[1], port.input[2] or 48, 64))
    assert y.shape[1] == port.output[1]


# (fixture, new size, deleted rows): shrink, grow, shrink and grow, the
# segmenter's 1x1 conv head
RESIZE_CASES = [('overfit.mlmodel', 12, [1, 3, 5, 15]), ('overfit.mlmodel', 20, None),
                ('overfit.mlmodel', 16, [0, 7]), ('blla_small.safetensors', 12, [3])]


@pytest.mark.parametrize('fixture, size, dropped', RESIZE_CASES)
def test_resize_output_equals_jax(fixture, size, dropped):
    jax, port = jax_models(RESOURCES / fixture)[0], port_models(RESOURCES / fixture)[0]
    before = port_arrays(port)
    jax.resize_output(size, dropped)
    port.resize_output(size, dropped, generator=torch.Generator().manual_seed(3))
    assert port.spec == jax.spec and port.output == jax.output
    assert port.user_metadata['vgsl'] == jax.user_metadata['vgsl']
    after, js = port_arrays(port), jax.state_dict()
    assert {k: v.shape for k, v in after.items()} == {k: np.asarray(v).shape for k, v in js.items()}
    last = port.net.names[-1]
    for k in after:
        if f'.{last}.' not in k:
            assert np.array_equal(after[k], before[k]), k
            continue
        keep = [i for i in range(before[k].shape[0]) if i not in set(dropped or [])]
        # surviving rows keep their values, in order, bit for bit (the JAX
        # package's too); the fresh rows follow, with zero biases
        assert np.array_equal(after[k][:len(keep)], before[k][keep])
        assert np.array_equal(np.asarray(js[k])[:len(keep)], before[k][keep])
        if k.endswith('bias'):
            assert not after[k][len(keep):].any()


def test_resize_output_refuses_a_non_output_layer():
    port = port_models(RESOURCES / 'overfit.mlmodel')[0]
    port.append(5, '[Lbx8]')
    with pytest.raises(ValueError, match='linear or convolutional'):
        port.resize_output(10)
