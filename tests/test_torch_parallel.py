"""
Data-parallel training of the port (``kraken_tpu_torch.parallel``) on the
CPU: two gloo ranks, each a new process, started once for the whole file
and running every case below (``python -m tests.test_torch_parallel DIR``
with the launcher's environment), held

- against the JAX package's step on a 2-device mesh (two of the eight
  virtual devices tests/conftest.py forces; ``make_train_step`` for CTC
  recognition and for segmentation with Dice at batch 1, padded to 2 as the
  mesh pads it, and at batch 2; the JAX trainer's sharded jit of the
  reading-order MLP's and of pretraining's ``loss_fn``, the JAX draws fed to
  the port's ranks row by row), on the same weights and global batch,
  dropout off: the ranks' mean loss within 1e-5 relative, their averaged
  gradients within the tolerances of tests/test_torch_train_parity.py
  (2e-5 of the largest, 2e-4 with GroupNorm, 1e-6 for the MLP) and the
  parameters after the step within 1e-6 of the largest magnitude (SGD, so
  that the update is the gradient's: Adam's first step divides each
  gradient by its own size, so that a gradient of noise size moves its
  element by the whole rate);
- against the port's own one-process step on the padded batch, through the
  sharded loader: B = 1 and B = 3 on 2 ranks (AdamW, 2 steps; the steps
  and what they record are ``parallel.recorded_steps``);
- for one shuffle order on every rank although each rank's loader was
  seeded otherwise (``ketos`` without ``--seed``), checkpoints from rank 0
  alone, and early stopping and reduce-on-plateau taking effect at the same
  step on both ranks of a fit;

the all-reduce in several buckets; ``ketos train -d cpu --devices 2`` to its
``model_best`` in a new process, and failing with rank 1's exit code and
stderr where rank 1 fails; the usage error for more cards than are
visible, and ``dryrun_multichip(2)``.
"""
import tests.test_torch_threads  # noqa: F401  (first: the thread share under xdist)
import contextlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from kraken_tpu_torch.parallel import pad_batch_to_multiple, recorded_steps

REPO = Path(__file__).resolve().parent.parent
RESOURCES = REPO / 'tests' / 'resources'
MERGE = RESOURCES / 'merge_tests'
REC_SPEC = '[1,16,0,1 Cr3,3,4,2,2 S1(1x0)1,3 Lbx8 O1c6]'
SEG_SPEC = '[1,32,0,3 Cr3,3,8,2,2 Gn2 Cr3,3,8,2,2 Gn2 O2l4]'
PRE_SPEC = '[1,24,0,1 Cr3,3,8 Mp2,2 S1(1x0)1,3 Lbx6 Lbx5]'
PRE_KW = dict(mask_width=2, mask_prob=0.5, num_negatives=6, logit_temp=0.1)
RO_MAPPING = {'default': 0, 'a': 1, 'b': 2}
GRAD_RTOL = {'rec': 2e-5, 'seg1': 2e-4, 'seg2': 2e-4, 'ro': 1e-6, 'pre': 2e-5}
LOSS_RTOL = 1e-5
PARAM_RTOL = 1e-6
# the synthetic line set of the loader cases: widths drawn so that the
# first line of the first shuffled batch is not its widest
LINES, LINE_SEED, LOADER_SEEDS = 9, 2, (1000, 2000)
FIT_SPEC = '[1,32,0,1 Cr3,3,4,2,2 S1(1x0)1,3 Lbx8]'
WAIT_S = 240
# a sitecustomize that makes rank 1 of ``ketos train --devices 2`` fail
# before it joins the group (RANK_1_FAILS=start) or once it trains (fit)
_FAILING_RANK = """
import os, sys
if os.environ.get('RANK') == '1':
    if os.environ['RANK_1_FAILS'] == 'start':
        sys.stderr.write('rank 1 cannot start\\n')
        sys.stderr.flush()
        os._exit(3)
    from kraken_tpu_torch.train import trainer

    def fit(self, *args, **kwargs):
        sys.stderr.write('rank 1 has no training data\\n')
        raise SystemExit(4)
    trainer.KrakenTrainer.fit = fit
"""


def _close(got, want, rel):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= rel * scale, float(np.abs(got - want).max())


# ------------------------------------------------------------- the ranks

class _Lines:
    """Synthetic recognition samples (16 px high, ragged widths, labels of
    1-6 classes) that record the indices they are asked for."""

    def __init__(self):
        rng = np.random.RandomState(LINE_SEED)
        self.samples = [{'image': rng.rand(1, 16, int(w)).astype(np.float32),
                         'target': rng.randint(1, 6, int(n)).tolist()}
                        for w, n in zip(rng.randint(20, 90, LINES), rng.randint(1, 6, LINES))]
        self.seen = []

    def __len__(self):
        return len(self.samples)

    def __getitem__(self, i):
        self.seen.append(i)
        return self.samples[i]


def _loader(batch_size, seed, shuffle=True):
    from kraken_tpu_torch.dataset.loader import DataLoader, bucket_collate, bucket_dims
    return DataLoader(_Lines(), batch_size=batch_size, shuffle=shuffle, collate_fn=bucket_collate,
                      seed=seed, dims_fn=bucket_dims)


def _module(case, device='cpu'):
    """The port's task module of a step case, on the case's weights."""
    from kraken_tpu_torch import configs
    from kraken_tpu_torch.vgsl import VGSLModel
    kind = case['kind']
    if kind == 'ro':
        from kraken_tpu_torch.ro.layers import ROMLP
        from kraken_tpu_torch.train.ro import ROModel
        net = ROMLP(class_mapping=RO_MAPPING, level='baselines')
        net.nn.load_state_dict(case['state'])
        module = ROModel(configs.ReadingOrderTrainingConfig(device=device, **case['config']),
                         net=net)
        module.setup('fit', None)
        return module
    net = VGSLModel(case['spec'], generator=torch.Generator().manual_seed(0))
    net.net.load_state_dict(case['state'])
    if kind == 'pre':
        from kraken_tpu_torch.codec import Codec
        from kraken_tpu_torch.pretrain import RecognitionPretrainModel
        net.add_codec(Codec(' '))
        module = RecognitionPretrainModel(configs.PretrainingConfig(
            spec=PRE_SPEC, device=device, **PRE_KW, **case['config']), net=net)
        module.setup('fit', None)
        module.pretrain.load_state_dict(case['pretrain'])
        return module
    if kind == 'rec':
        from kraken_tpu_torch.train.recognition import RecognitionModel
        module = RecognitionModel(configs.RecognitionTrainingConfig(device=device,
                                                                    **case['config']), net=net)
    else:
        from kraken_tpu_torch.train.segmentation import SegmentationModel
        module = SegmentationModel(configs.SegmentationTrainingConfig(device=device,
                                                                      **case['config']), net=net)
    module._place_for_training()
    return module


def _rank_fit(world, work: Path) -> dict:
    """A recognition fit on the four merge_tests lines, batch 1, validating
    every epoch: early stopping after 2 validations without a gain of 1
    (every validation after the first), reduce-on-plateau after 1; the
    reduce-on-plateau scale of every optimizer step recorded."""
    from kraken_tpu_torch.configs import RecognitionTrainingConfig, RecognitionTrainingDataConfig
    from kraken_tpu_torch.train import (KrakenTrainer, Optimizer, RecognitionDataModule,
                                        RecognitionModel)
    scales = []
    step_fn = Optimizer.step

    def spy(self, rop_scale=1.0):
        scales.append(rop_scale)
        return step_fn(self, rop_scale)
    Optimizer.step = spy
    # each rank draws its own numpy state, as without ketos --seed
    np.random.seed(world.rank + 7)
    config = RecognitionTrainingConfig(
        device='cpu', spec=FIT_SPEC, epochs=6, quit='early', lag=2, min_delta=1.0,
        schedule='reduceonplateau', rop_patience=1,
        checkpoint_path=str(work / f'fit{world.rank}' / 'model'))
    dm = RecognitionDataModule(RecognitionTrainingDataConfig(
        training_data=[str(MERGE / f'{n}.jpg') for n in ('0006', '0007', '0008', '0021')],
        format_type='path', batch_size=1, num_workers=0))
    trainer = KrakenTrainer(config, mesh=world)
    trainer.fit(RecognitionModel(config), dm)
    Optimizer.step = step_fn
    return {'epoch': trainer.current_epoch, 'global_step': trainer.global_step,
            'scales': scales, 'params': [p.detach().clone() for p in trainer.optimizer.params],
            'files': sorted(p.name for p in (work / f'fit{world.rank}').glob('*'))}


def _rank_buckets(world, case) -> dict:
    """The recognition step again with the all-reduce cut into buckets of
    BUCKET_BYTES = 1 KiB: the gradients and the sizes of the buckets."""
    import torch.distributed as dist
    from kraken_tpu_torch.parallel import mesh, shard_batch
    sizes, reduce = [], dist.all_reduce

    def counted(tensor, *args, **kwargs):
        sizes.append(tensor.numel())
        return reduce(tensor, *args, **kwargs)
    module = _module(case)
    module.world = world
    bucket_bytes = mesh.BUCKET_BYTES
    mesh.BUCKET_BYTES, dist.all_reduce = 1024, counted
    try:
        res = recorded_steps(module, shard_batch(case['batch'], world), world, 1)
    finally:
        mesh.BUCKET_BYTES, dist.all_reduce = bucket_bytes, reduce
    return {'grads': res['grads'], 'sizes': sizes}


def _rank_main(work: Path) -> None:
    from kraken_tpu_torch.parallel import shard_batch, world_from_env
    world = world_from_env('cpu')
    try:
        inputs = torch.load(work / 'inputs.pt', weights_only=False)
        out = {'steps': {}, 'loader': {}}
        for name, case in inputs['steps'].items():
            module = _module(case)
            module.world = world
            kwargs = {}
            if case['kind'] == 'pre':
                starts, neg = case['indices']
                rows = world.rows(len(starts))
                kwargs['indices'] = (starts[rows], neg[:, rows])
            res = recorded_steps(module, shard_batch(case['batch'], world), world, 1, **kwargs)
            res['mean_loss'] = world.mean(torch.tensor(res['losses'][0]))
            out['steps'][name] = res
        out['buckets'] = _rank_buckets(world, inputs['steps']['rec'])
        for batch_size in (1, 3):
            # each rank's loader seeded otherwise: after shard() every rank
            # walks rank 0's order
            loader = _loader(batch_size, LOADER_SEEDS[world.rank]).shard(world)
            epochs = [[(list(map(int, b['seq_lens'])), b['image'].shape) for b in loader]
                      for _ in range(2)]
            seen = list(loader.dataset.seen)
            first = next(iter(_loader(batch_size, LOADER_SEEDS[world.rank]).shard(world)))
            module = _module(inputs['loader_model'])
            module.world = world
            res = recorded_steps(module, first, world, 2)
            res['mean_losses'] = [world.mean(torch.tensor(v)) for v in res['losses']]
            out['loader'][batch_size] = {'seen': seen, 'epochs': epochs, 'step': res,
                                         'width': first['image'].shape[3],
                                         'label_len': first['target'].shape[1]}
        out['fit'] = _rank_fit(world, work)
        torch.save(out, work / f'out{world.rank}.pt')
    finally:
        world.close()


# ----------------------------------------------------------- JAX and port

def _port_cases():
    """The step cases as the ranks take them: the port's weights (from
    seeds), the global batches and pretraining's draws (``jax.random``'s,
    as the JAX loss draws them)."""
    import jax
    from kraken_tpu_torch.codec import Codec
    from kraken_tpu_torch.configs import PretrainingConfig
    from kraken_tpu_torch.pretrain import RecognitionPretrainModel
    from kraken_tpu_torch.ro.layers import ROMLP
    from kraken_tpu_torch.vgsl import VGSLModel
    from tests.test_torch_pretrain_parity import _jax_draws

    def net(spec, seed):
        return VGSLModel(spec, generator=torch.Generator().manual_seed(seed))

    sgd = dict(optimizer='SGD', lrate=1e-2, momentum=0.9)
    rng = np.random.RandomState(0)
    cases = {'rec': {'kind': 'rec', 'spec': REC_SPEC, 'state': net(REC_SPEC, 0).net.state_dict(),
                     'config': sgd,
                     'batch': {'image': rng.rand(4, 1, 16, 64).astype(np.float32),
                               'seq_lens': np.array([64, 50, 37, 64], np.int32),
                               'target': rng.randint(1, 6, (4, 4)).astype(np.int32),
                               'target_lens': np.array([4, 3, 2, 4], np.int32)}}}
    pages = {'image': rng.rand(2, 3, 32, 32).astype(np.float32),
             'target': (rng.rand(2, 4, 8, 8) > 0.5).astype(np.float32)}
    seg = net(SEG_SPEC, 2).net.state_dict()
    for name, n in (('seg1', 1), ('seg2', 2)):
        unpadded = {k: v[:n] for k, v in pages.items()}
        cases[name] = {'kind': 'seg', 'spec': SEG_SPEC, 'state': seg, 'config': sgd,
                       'unpadded': unpadded, 'batch': pad_batch_to_multiple(unpadded, 2)}
    ro = ROMLP(class_mapping=RO_MAPPING, level='baselines', generator=torch.Generator().manual_seed(3))
    cases['ro'] = {'kind': 'ro', 'config': sgd, 'state': ro.nn.state_dict(),
                   'batch': {'sample': rng.rand(16, ro.feature_size).astype(np.float32),
                             'target': (rng.rand(16) > 0.5).astype(np.float32)}}
    pre_net = net(PRE_SPEC, 4)
    pre_net.add_codec(Codec(' '))
    pre = RecognitionPretrainModel(PretrainingConfig(spec=PRE_SPEC, device='cpu', **PRE_KW),
                                   net=pre_net)
    pre.setup('fit', None)
    batch = {'image': rng.rand(4, 1, 24, 40).astype(np.float32),
             'seq_lens': np.array([40, 29, 11, 35], np.int32)}
    with torch.no_grad():
        feats, _ = pre._features(torch.from_numpy(batch['image']),
                                 torch.from_numpy(batch['seq_lens']))
    key = jax.random.PRNGKey(7)
    cases['pre'] = {'kind': 'pre', 'config': sgd, 'batch': batch, 'key': key,
                    'spec': pre.net.spec, 'state': pre.net.net.state_dict(),
                    'pretrain': pre.pretrain.state_dict(),
                    'indices': _jax_draws(key, feats.shape[0], feats.shape[3],
                                          PRE_KW['mask_width'], PRE_KW['num_negatives'])}
    for case in cases.values():
        for k in ('state', 'pretrain'):
            if k in case:
                case[k] = {n: v.detach().clone() for n, v in case[k].items()}
    return cases


@contextlib.contextmanager
def _abstract_init():
    """The JAX package's networks built with their random init only traced
    (``jax.eval_shape``): the step cases load the port's weights into every
    parameter (a leaf left out fails the load), and the eager init compiles
    each initializer's ops one by one."""
    import jax
    import kraken_tpu.vgsl as jax_vgsl
    parse = jax_vgsl.parse_vgsl

    def abstract(spec):
        parsed = parse(spec)
        init = parsed[1].init
        object.__setattr__(parsed[1], 'init', lambda rng: jax.eval_shape(init, rng))
        return parsed
    jax_vgsl.parse_vgsl = abstract
    try:
        yield
    finally:
        jax_vgsl.parse_vgsl = parse


def _jax_module(case):
    """The JAX side of a step case on the port's weights: (net or module,
    its config)."""
    with _abstract_init():
        return _jax_module_of(case)


def _jax_module_of(case):
    import jax
    import jax.numpy as jnp
    from kraken_tpu import configs as jax_configs
    from kraken_tpu.vgsl import VGSLModel as JaxVGSL
    kind = case['kind']
    sd = {f'nn.{k}': v.numpy() for k, v in case['state'].items()}
    if kind == 'ro':
        from kraken_tpu.ro.layers import ROMLP as JaxROMLP
        from kraken_tpu.train.ro import ROModel as JaxROModel

        class _DM:
            class_mapping = RO_MAPPING
        config = jax_configs.ReadingOrderTrainingConfig(**case['config'])
        jro = JaxROModel(config, net=JaxROMLP(rng=jax.random.PRNGKey(2),
                                              class_mapping=RO_MAPPING, level='baselines'))
        jro.setup('fit', _DM())
        jro.net.params = {k: jnp.asarray(v.numpy()) for k, v in case['state'].items()}
        return jro, config
    if kind == 'pre':
        from kraken_tpu.pretrain.model import RecognitionPretrainModel as JaxPretrain
        config = jax_configs.PretrainingConfig(spec=PRE_SPEC, **PRE_KW, **case['config'])
        jm = JaxPretrain(config, net=JaxVGSL(PRE_SPEC, rng=jax.random.PRNGKey(0),
                                             model_type=['recognition']))
        jm.setup('fit', None)
        sd.update({f'nn.__pretrain__.{k}': v.numpy() for k, v in case['pretrain'].items()})
        jm.net.load_state_dict(sd)
        return jm, config
    net = JaxVGSL(case['spec'], rng=jax.random.PRNGKey(0))
    net.load_state_dict(sd)
    return net, jax_configs.RecognitionTrainingConfig(**case['config'])


def _jax_step(case):
    """The JAX step on a 2-device mesh (``make_train_step`` for CTC and
    segmentation, the JAX trainer's sharded jit of the module's ``loss_fn``
    otherwise) on the port's weights: the loss, the gradient (``jax.grad``
    of the same loss on the unsharded batch, or the sharded step's own) and
    the parameters after the step."""
    import jax
    import jax.numpy as jnp
    import optax
    from kraken_tpu.parallel import (batch_sharding, make_mesh, make_train_step, replicate,
                                     shard_batch)
    from kraken_tpu.train import losses as jax_losses
    from kraken_tpu.train.optim import build_optimizer
    mesh = make_mesh(jax.devices()[:2])
    repl, data = replicate(mesh), batch_sharding(mesh)
    model, config = _jax_module(case)
    tx = build_optimizer(config, 1)
    params = model.params if case['kind'] in ('rec', 'seg') else model.net.params
    args = (jax.device_put(params, repl), jax.device_put(tx.init(params), repl),
            shard_batch(case['batch'], mesh),
            jax.device_put(case.get('key', jax.random.PRNGKey(1)), repl))
    if case['kind'] in ('rec', 'seg'):
        net = model.net
        step = make_train_step(net, tx, loss='ctc' if case['kind'] == 'rec' else 'segmentation',
                               mesh=mesh)

        def loss_fn(p, b):
            if case['kind'] == 'rec':
                logits, olens = net.apply(p, b['image'], b['seq_lens'])
                return jax_losses.ctc_loss(logits, olens, b['target'],
                                           b['target_lens']) / b['image'].shape[0]
            return jax_losses.segmentation_loss(net.apply(p, b['image'], None)[0], b['target'])
        new, _, loss = step(*args)
        grads = jax.jit(jax.grad(loss_fn))(params, {k: jnp.asarray(v)
                                                   for k, v in case['batch'].items()})
        return float(loss), grads, new

    def sharded(params, opt_state, batch, rng):
        value, grads = jax.value_and_grad(model.loss_fn)(params, batch, rng)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), value, grads
    new, loss, grads = jax.jit(sharded, in_shardings=(repl, repl, data, repl),
                               out_shardings=(repl, repl, repl))(*args)
    return float(loss), grads, new


def _flat(tree, kind) -> dict:
    if kind == 'ro':
        return {k: np.asarray(v) for k, v in tree.items()}
    flat = {f'{layer}.{k}': np.asarray(v) for layer, d in tree.items() for k, v in d.items()}
    return {k.replace('__pretrain__.', 'pretrain.'): v for k, v in flat.items()}


def _names(case) -> list:
    module = _module(case)
    names = [n for n, _ in (module.net.nn if case['kind'] == 'ro'
                            else module._torch_net()).named_parameters()]
    if case['kind'] == 'pre':
        names += [f'pretrain.{n}' for n, _ in module.pretrain.named_parameters()]
    return names


def _one_process(batch_size, model_case):
    """The port's step on the padded global batch of the loader case, in
    this process (rank 0's loader seed)."""
    loader = _loader(batch_size, LOADER_SEEDS[0])
    idx = pad_batch_to_multiple({'i': loader.batches()[0]}, 2)['i']
    batch = loader.collate_fn([loader.dataset.samples[i] for i in idx])
    return idx, batch, recorded_steps(_module(model_case), batch, None, 2)


# ------------------------------------------------------------- fixtures

@pytest.fixture(scope='module')
def started(tmp_path_factory):
    """Starts, at once, ``ketos train -d cpu --devices 2`` in new
    processes (once as it is, once for each way its rank 1 fails), the two
    ranks (their inputs written first) and ``dryrun_multichip(2)`` on a
    thread; the JAX side is built meanwhile."""
    import threading
    from kraken_tpu_torch.parallel.dryrun import dryrun_multichip
    from kraken_tpu_torch.parallel.launch import free_port, start_ranks
    from tests.test_torch_threads import subprocess_env
    work = tmp_path_factory.mktemp('parallel')

    def ketos_train(out, env):
        return subprocess.Popen(
            [sys.executable, '-m', 'kraken_tpu_torch.ketos', '-d', 'cpu', 'train', '--devices',
             '2', '-f', 'path', '-N', '1', '-B', '2', '-s', FIT_SPEC, '-o', str(out)]
            + [str(MERGE / f'{n}.jpg') for n in ('0006', '0007', '0008', '0021')],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    cli = ketos_train(work / 'cli' / 'model', subprocess_env())
    # rank 1 failing, through a sitecustomize on its path (rank 0, started
    # by hand, has no RANK)
    site = work / 'site'
    site.mkdir()
    (site / 'sitecustomize.py').write_text(_FAILING_RANK)
    failing = {when: ketos_train(work / f'failing_{when}' / 'model',
                                 dict(subprocess_env(), PYTHONPATH=str(site), RANK_1_FAILS=when))
               for when in ('start', 'fit')}
    cases = _port_cases()
    loader_model = dict(cases['rec'], config={})
    torch.save({'steps': {name: {k: v for k, v in case.items() if k not in ('key', 'unpadded')}
                          for name, case in cases.items()},
                'loader_model': loader_model}, work / 'inputs.pt')
    ranks = start_ranks(['-m', 'tests.test_torch_parallel', str(work)], 2, range(2), free_port(),
                        env=subprocess_env())
    dryrun = {}

    def run_dryrun():
        try:
            dryrun_multichip(2)
        except BaseException as e:  # re-raised by test_dryrun_multichip
            dryrun['error'] = e
    thread = threading.Thread(target=run_dryrun)
    thread.start()
    yield {'work': work, 'cases': cases, 'ranks': ranks, 'cli': cli, 'failing': failing,
           'loader_model': loader_model, 'dryrun': (thread, dryrun)}
    thread.join()
    for proc in [cli, *failing.values(), *ranks.procs.values()]:
        if proc.poll() is None:
            proc.kill()


@pytest.fixture(scope='module')
def ranks(started):
    """The two ranks' results (the cases that compare them with the JAX
    package's step wait for them only once their JAX side is done)."""
    return _results(started)


def _results(started) -> list:
    if 'results' not in started:
        started['ranks'].wait(WAIT_S)
        started['results'] = [torch.load(started['work'] / f'out{r}.pt', weights_only=False)
                              for r in range(2)]
    return started['results']


# ---------------------------------------------------------------- tests

@pytest.mark.parametrize('name', ['rec', 'seg1', 'seg2', 'ro', 'pre'])
def test_two_rank_step_matches_the_jax_mesh_step(started, name):
    case = started['cases'][name]
    want_loss, want_grads, want_params = _jax_step(case)
    got = [r['steps'][name] for r in _results(started)]
    assert abs(got[0]['mean_loss'] - want_loss) <= LOSS_RTOL * abs(want_loss)
    # both ranks handed the optimizer the same averaged gradients and hold
    # the same parameters after the step
    for a, b in zip(got[0]['grads'] + got[0]['params'], got[1]['grads'] + got[1]['params']):
        assert (a is None and b is None) or torch.equal(a, b)
    names = _names(case)
    want_g, want_p = _flat(want_grads, case['kind']), _flat(want_params, case['kind'])
    assert set(want_g) == set(names)
    scale = max(float(np.abs(v).max()) for v in want_p.values())
    for n, g, p in zip(names, got[0]['grads'], got[0]['params']):
        # the pretraining output layer takes no part in the loss (JAX: a
        # zero gradient, the port: none)
        _close(np.zeros_like(want_g[n]) if g is None else g, want_g[n], GRAD_RTOL[name])
        assert float(np.abs(p.numpy() - want_p[n]).max()) <= PARAM_RTOL * scale, n
    if name == 'seg1':
        # at batch 1 both ranks hold the page, and the Dice term is the
        # padded batch's (its sums twice the page's), not the page's alone
        from kraken_tpu_torch.train import losses
        logits = torch.randn(1, 4, 8, 8, generator=torch.Generator().manual_seed(0))
        target = torch.from_numpy(case['unpadded']['target'])
        assert float(losses.dice_loss(logits.repeat(2, 1, 1, 1), target.repeat(2, 1, 1, 1))) \
            != pytest.approx(float(losses.dice_loss(logits, target)), rel=1e-4)


@pytest.mark.parametrize('batch_size', [1, 3])
def test_two_ranks_match_one_process_on_the_padded_batch(started, ranks, batch_size):
    idx, batch, want = _one_process(batch_size, started['loader_model'])
    got = [r['loader'][batch_size] for r in ranks]
    # each rank loaded only its contiguous rows of the padded batch, padded
    # to the global batch's width and label buckets
    for r, g in enumerate(got):
        assert g['seen'][:len(idx) // 2] == list(idx[r * len(idx) // 2:(r + 1) * len(idx) // 2])
        assert g['width'] == batch['image'].shape[3]
        assert g['label_len'] == batch['target'].shape[1]
    for step in range(2):
        mean = got[0]['step']['mean_losses'][step]
        assert abs(mean - want['losses'][step]) <= LOSS_RTOL * abs(want['losses'][step])
    scale = max(float(p.abs().max()) for p in want['params'])
    for a, b, w in zip(got[0]['step']['params'], got[1]['step']['params'], want['params']):
        assert torch.equal(a, b)
        assert float((a - w).abs().max()) <= PARAM_RTOL * scale


def test_ragged_batches_repeat_the_first_line_in_sampler_order(started, ranks):
    """The one difference by decision (ROADMAP.md queue 3): with 3 lines on
    2 ranks the port pads the global batch with the first line the sampler
    drew, which a rank can know before it loads; the JAX package collates
    first (widest line first) and repeats the widest."""
    from kraken_tpu.parallel import pad_batch_to_multiple as jax_pad
    from kraken_tpu_torch.dataset.loader import bucket_collate
    idx, batch, _ = _one_process(3, started['loader_model'])
    samples = _loader(3, LOADER_SEEDS[0]).dataset.samples
    widths = [samples[i]['image'].shape[2] for i in idx]
    assert len(idx) == 4 and idx[3] == idx[0]
    assert widths[0] < max(widths[:3]), 'the first line drawn is not the widest'
    assert ranks[1]['loader'][3]['seen'][:2] == [int(idx[2]), int(idx[0])]
    jax_batch = jax_pad({k: v for k, v in bucket_collate([samples[i] for i in idx[:3]]).items()
                         if k != 'target'}, 2)
    assert int(jax_batch['seq_lens'][3]) == max(widths[:3]) != widths[3]


def test_every_rank_walks_one_shuffle_order(ranks):
    """Rank 1's loader was seeded otherwise than rank 0's (as ranks are
    without ``ketos --seed``); over two epochs both walk rank 0's order, each
    its own rows of every padded batch."""
    for batch_size in (1, 3):
        loader = _loader(batch_size, LOADER_SEEDS[0])
        order = [pad_batch_to_multiple({'i': b}, 2)['i'] for _ in range(2)
                 for b in loader.batches()]
        assert len(loader) == -(-LINES // batch_size)
        for r in range(2):
            want = [int(i) for b in order for i in b[r * len(b) // 2:(r + 1) * len(b) // 2]]
            assert ranks[r]['loader'][batch_size]['seen'][:len(want)] == want
            shapes = [[s for _, s in e] for e in ranks[r]['loader'][batch_size]['epochs']]
            assert shapes == [[s for _, s in e] for e in ranks[0]['loader'][batch_size]['epochs']]


def test_fit_decides_on_rank_0_and_every_rank_follows(ranks):
    """Early stopping (lag 2) and reduce-on-plateau (patience 1) take effect
    at the same step on both ranks, which end with the same parameters;
    only rank 0 writes checkpoints."""
    fits = [r['fit'] for r in ranks]
    assert fits[0]['epoch'] == fits[1]['epoch'] == 2
    # three steps an epoch (3 training lines, batch 1); the rate is reduced
    # after the second validation, and the third stops the fit
    assert fits[0]['global_step'] == fits[1]['global_step'] == len(fits[0]['scales']) == 9
    assert fits[0]['scales'] == fits[1]['scales'] == [1.0] * 6 + [pytest.approx(0.1)] * 3
    for a, b in zip(fits[0]['params'], fits[1]['params']):
        assert torch.equal(a, b)
    assert fits[0]['files'] == ['model_0.safetensors', 'model_1.safetensors',
                                'model_2.safetensors', 'model_best.safetensors']
    assert fits[1]['files'] == []


def test_ketos_train_on_two_ranks(started):
    out, err = started['cli'].communicate(timeout=WAIT_S)
    assert started['cli'].returncode == 0, err[-3000:]
    assert (started['work'] / 'cli' / 'model_best.safetensors').exists()
    assert out.count('Best model written') == 1


@pytest.mark.parametrize('when, code, says', [('start', 3, 'rank 1 cannot start'),
                                              ('fit', 4, 'rank 1 has no training data')])
def test_a_failed_rank_fails_ketos_train_with_its_code(started, when, code, says):
    """Rank 1 fails before it joins (rank 0 waits in the rendezvous) or
    after (rank 0's collective fails with a gloo error): the command exits
    with rank 1's code and the end of its stderr."""
    proc = started['failing'][when]
    out, err = proc.communicate(timeout=WAIT_S)
    assert proc.returncode == code, err[-3000:]
    assert f'rank 1 exited with code {code}; the end of its stderr:' in err, err[-3000:]
    assert says in err
    assert 'Best model written' not in out


def test_the_all_reduce_in_several_buckets_sums_alike(ranks):
    """The recognition step's all-reduce cut into buckets of 1 KiB hands
    the optimizer the gradients that one bucket does, bit for bit."""
    for r in ranks:
        got, want = r['buckets'], r['steps']['rec']['grads']
        assert len(got['sizes']) > 1
        assert sum(got['sizes']) == sum(g.numel() for g in want if g is not None)
        for a, b in zip(got['grads'], want):
            assert (a is None and b is None) or torch.equal(a, b)


def test_buckets_split_on_size_and_dtype():
    from kraken_tpu_torch.parallel.mesh import _buckets
    grads = [torch.zeros(100), torch.zeros(100), torch.zeros(300),
             torch.zeros(10, dtype=torch.float64), torch.zeros(10)]
    assert [[g.numel() for g in b] for b in _buckets(grads, 800)] == [[100, 100], [300], [10], [10]]


def test_more_devices_than_cards_is_a_usage_error(monkeypatch, tmp_path):
    from click.testing import CliRunner
    from kraken_tpu_torch.ketos import cli
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: True)
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    result = CliRunner().invoke(cli, ['-d', 'cuda', 'train', '--devices', '2', '-f', 'path',
                                      '-o', str(tmp_path / 'm'), str(MERGE / '0006.jpg')])
    assert result.exit_code == 2, result.output
    assert '--devices 2 requested but only 1 CUDA device(s) are visible' in result.output
    assert not list(tmp_path.iterdir())


def test_dryrun_multichip(started):
    """``dryrun_multichip(2)``, called on a thread when the file starts."""
    thread, result = started['dryrun']
    thread.join(WAIT_S)
    assert not thread.is_alive()
    if 'error' in result:
        raise result['error']


@pytest.mark.parametrize('batch, n, want', [
    ({'a': np.arange(3)}, 2, [0, 1, 2, 0]), ({'a': np.arange(5)}, 4, [0, 1, 2, 3, 4, 0, 1, 2]),
    ({'a': np.arange(1)}, 3, [0, 0, 0]), ({'a': np.arange(4)}, 2, [0, 1, 2, 3])])
def test_pad_batch_to_multiple_is_the_jax_packages(batch, n, want):
    from kraken_tpu.parallel import pad_batch_to_multiple as jax_pad
    assert pad_batch_to_multiple(batch, n)['a'].tolist() == want == jax_pad(batch, n)['a'].tolist()


if __name__ == '__main__':
    _rank_main(Path(sys.argv[1]))
