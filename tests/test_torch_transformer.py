"""
The transformer encoder block (``Te`` specs, the JAX package's VGSL
extension) in the port against the JAX package on the CPU, fp32:

- the block's parts (LayerNorm, interleaved-pair RoPE) and the layer on
  ragged and unpadded batches, atol 1e-5, and its checks (``must equal``,
  ``divisible``, an even head dim, H == 1);
- the specs of tests/test_vgsl.py:304-375 (parse and shapes, ragged
  padding, two blocks with an explicit dropout field) held to the JAX
  forward. Those specs put a 32-group GroupNorm (one channel a group)
  before the blocks, which scales its channels to |y| up to ~15, so the
  reduction-order rounding of both packages' GroupNorms (3.5e-5 there)
  reaches the logits: they are held at atol 1e-5 plus rtol 1e-5; a spec
  without the GroupNorm is held at atol 1e-5 alone;
- ``tests/resources/te_small.safetensors``, written by the JAX package
  (which refuses to write ``Te`` to CoreML), through the port's
  safetensors reader, and its ``rpred`` records on ``bw.png`` (box
  segmentation) and on the fixture page (baselines) equal to the JAX
  package's (``torch_te_golden.json``).

Write the fixture model and its golden anew with
``JAX_PLATFORMS=cpu python -m tests.test_torch_transformer``.
"""
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kraken_tpu.nn import layers as jax_layers
from kraken_tpu.vgsl import VGSLModel as JaxVGSLModel
from kraken_tpu_torch.nn.layers import TransformerEncoder
from kraken_tpu_torch.vgsl import VGSLModel
from tests.test_torch_legacy_lstm import batch, page_records, write_fixture

RESOURCES = Path(__file__).resolve().parent / 'resources'
MODEL = RESOURCES / 'te_small.safetensors'
GOLDEN = RESOURCES / 'torch_te_golden.json'
MODEL_SPEC = '[1,48,0,1 Cr3,3,8,2,2 Mp2,2 S1(1x0)1,3 Cl1,1,16 Te2,16,32 Te2,16,32 O1c30]'


def randomized(sd: dict, seed: int) -> dict:
    """A state dict whose Te biases and LayerNorm weights (zero and one at
    init) are random."""
    rng = np.random.RandomState(seed)
    out = dict(sd)
    for k in sorted(out):
        if '.Te_' in k and ('bias' in k or 'norm' in k):
            out[k] = (out[k] + rng.randn(*out[k].shape) * 0.3).astype(np.float32)
    return out


def pair(spec: str, seed: int = 0):
    jm = JaxVGSLModel(vgsl=spec, rng=jax.random.PRNGKey(seed))
    sd = randomized(jm.state_dict(), seed)
    jm.load_state_dict(sd)
    tm = VGSLModel(spec)
    tm.from_jax_state_dict(sd)
    return jm, tm


def layer_pair(dim=32, heads=4, ffn=48, seed=0):
    jl = jax_layers.TransformerEncoder(dim, heads, dim, ffn)
    params = {f'nn.Te_0.{k}': np.asarray(v) for k, v in jl.init(jax.random.PRNGKey(seed)).items()}
    params = {k[len('nn.Te_0.'):]: v for k, v in randomized(params, seed).items()}
    tl = TransformerEncoder(dim, heads, dim, ffn).eval()
    tl.load_state_dict({k: torch.from_numpy(np.array(v)) for k, v in params.items()})
    return jl, {k: jnp.asarray(v) for k, v in params.items()}, tl


def test_layernorm_and_rope_match_jax():
    rng = np.random.RandomState(1)
    _, params, tl = layer_pair()
    x = rng.randn(3, 40, 32).astype(np.float32) * 3 + 1
    ln_j = jax_layers.TransformerEncoder._layernorm(jnp.asarray(x), params['norm1.weight'],
                                                    params['norm1.bias'])
    ln_t = TransformerEncoder._layernorm(torch.from_numpy(x), tl.norm1)
    np.testing.assert_allclose(ln_t.numpy(), np.asarray(ln_j), atol=1e-5)
    q = rng.randn(2, 4, 300, 8).astype(np.float32)
    np.testing.assert_allclose(TransformerEncoder._rope(torch.from_numpy(q)).numpy(),
                               np.asarray(jax_layers.TransformerEncoder._rope(jnp.asarray(q))),
                               atol=1e-5)


@pytest.mark.parametrize('lens', [None, [40, 23, 1, 64]])
def test_layer_matches_jax(lens):
    jl, params, tl = layer_pair(seed=2)
    x = np.random.RandomState(2).randn(4, 32, 1, 40).astype(np.float32)
    sl = None if lens is None else np.array(lens, np.int32)
    yj, _ = jl.apply(params, jnp.asarray(x), None if sl is None else jnp.asarray(sl))
    with torch.no_grad():
        yt, lt = tl(torch.from_numpy(x), None if sl is None else torch.from_numpy(sl))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5)
    if sl is not None:
        assert torch.equal(lt, torch.from_numpy(sl))
        assert torch.all(yt[1, :, :, 23:] == 0) and torch.all(yt[2, :, :, 1:] == 0)


def test_layer_checks():
    with pytest.raises(ValueError, match='must equal'):
        VGSLModel('[1,48,0,1 Cr3,3,32,2,2 S1(1x0)1,3 Te4,64,128 O1c12]')
    with pytest.raises(ValueError, match='divisible'):
        TransformerEncoder(input_size=60, heads=7, dim=60, ffn_dim=120)
    with pytest.raises(ValueError, match='even'):
        TransformerEncoder(input_size=12, heads=4, dim=12, ffn_dim=24)
    with pytest.raises(ValueError, match='height 1'):
        TransformerEncoder(8, 2, 8, 16)(torch.zeros(1, 8, 2, 5))


def test_parse_and_shapes():
    spec = '[1,48,0,1 Cr3,3,32,2,2 Gn32 S1(1x0)1,3 Cl1,1,64 Te4,64,128 Te4,64,128,20 O1c12]'
    jm, tm = pair(spec, seed=3)
    assert tm.output == jm.output == (1, 12, 1, 1) and tm.named_spec == jm.named_spec
    te = [m for m in tm.net.layers if isinstance(m, TransformerEncoder)]
    assert len(te) == 2
    assert (te[0].heads, te[0].dim, te[0].ffn_dim) == (4, 64, 128)
    assert te[0].dropout == pytest.approx(0.1) and te[1].dropout == pytest.approx(0.2)
    lens = np.array([96, 48], np.int32)
    x = np.random.RandomState(3).rand(2, 1, 48, 96).astype(np.float32)
    yj, lj = jax.jit(jm.net.apply)(jm.params, jnp.asarray(x), jnp.asarray(lens))
    with torch.no_grad():
        yt, lt = tm(torch.from_numpy(x), torch.from_numpy(lens))
    assert yt.shape == (2, 12, 1, 48) and lt.tolist() == [48, 24]
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize('spec, gn', [
    ('[1,48,0,1 Cr3,3,32,2,2 Gn32 S1(1x0)1,3 Cl1,1,64 Te4,64,128 Te4,64,128 O1c7]', True),
    ('[1,48,0,1 Cr3,3,32,2,2 S1(1x0)1,3 Cl1,1,64 Te4,64,128 Te4,64,128,20 O1c7]', False),
])
def test_ragged_network_matches_jax(spec, gn):
    """The padding test's batch (a row zeroed past 80 of 128 columns) and a
    stack of two blocks, held to the JAX forward; the padded row's valid
    columns also match the row alone."""
    jm, tm = pair(spec, seed=4)
    lens = np.array([128, 80], np.int32)
    x = batch((2, 1, 48, 128), lens, seed=4)
    yj, lj = jax.jit(jm.net.apply)(jm.params, jnp.asarray(x), jnp.asarray(lens))
    with torch.no_grad():
        yt, lt = tm(torch.from_numpy(x), torch.from_numpy(lens))
        y1, _ = tm(torch.from_numpy(x[1:2, :, :, :80]), torch.from_numpy(lens[1:]))
    np.testing.assert_array_equal(lt.numpy(), np.asarray(lj))
    np.testing.assert_allclose(yt.numpy(), np.asarray(yj), atol=1e-5, rtol=1e-5 if gn else 0)
    torch.testing.assert_close(yt[1:2, :, :, :y1.shape[-1]], y1, atol=5e-4, rtol=0)


def test_state_dict_names_match_jax():
    jm, tm = pair(MODEL_SPEC)
    sj, st = jm.state_dict(), tm.state_dict()
    assert set(st) == set(sj)
    assert {'nn.Te_4.attn.qkv.weight', 'nn.Te_4.attn.out.bias', 'nn.Te_5.ffn.lin1.weight',
            'nn.Te_5.ffn.lin2.bias', 'nn.Te_5.norm2.weight'} <= set(st)
    for k in sj:
        np.testing.assert_array_equal(st[k].numpy(), sj[k], err_msg=k)


def test_preset_builds():
    """The JAX package's ``tpu-attn`` recognition preset (four Te8,256,1024
    blocks) builds in the port with the JAX shapes."""
    from kraken_tpu.configs.base import RECOGNITION_SPEC_PRESETS
    spec = RECOGNITION_SPEC_PRESETS['tpu-attn'][:-1] + ' O1c17]'
    model = VGSLModel(spec, generator=torch.Generator().manual_seed(0))
    assert model.output == (1, 17, 1, 1)
    assert sum(isinstance(m, TransformerEncoder) for m in model.net.modules()) == 4


def test_safetensors_fixture_loads_like_jax():
    from kraken_tpu.models import load_models as jax_load_models
    from kraken_tpu_torch.models import load_models
    (ours,), (theirs,) = load_models(MODEL), jax_load_models(MODEL)
    assert ours.spec == theirs.spec and ours.model_type == ['recognition']
    sa, sb = ours.state_dict(), theirs.state_dict()
    assert set(sa) == set(sb)
    for k in sb:
        np.testing.assert_array_equal(sa[k].numpy(), sb[k], err_msg=k)
    assert ours.codec.c2l == theirs.codec.c2l


@pytest.mark.parametrize('kind', ['bw', 'page'])
def test_rpred_records_equal_jax(kind):
    golden = json.loads(GOLDEN.read_text(encoding='utf-8'))[kind]
    ours = page_records(kind, 'kraken_tpu_torch', MODEL)
    assert len(ours) == len(golden) > 20
    assert sum(len(r['prediction']) for r in ours) > 0
    for a, b in zip(ours, golden):
        assert a['prediction'] == b['prediction']
        assert a['cuts_sha256'] == b['cuts_sha256']
        np.testing.assert_allclose(a['confidences'], b['confidences'], atol=1e-5)


if __name__ == '__main__':
    write_fixture(MODEL, MODEL_SPEC, 0, 'safetensors')
    GOLDEN.write_text(json.dumps({kind: page_records(kind, 'kraken_tpu', MODEL)
                                  for kind in ('bw', 'page')}, ensure_ascii=False, indent=0),
                      encoding='utf-8')
    print(f'wrote {MODEL} and {GOLDEN}')
