"""
ketos train and test (reference: kraken/ketos/recognition.py), the
counterparts of the JAX package's: ``train`` trains a text recognition
model on ``--device`` (in float32; on ``--devices N`` processes, one a
device) and writes checkpoints and the best model; ``test`` evaluates recognition models on a test set on ``--device``
and prints the accuracy report.
"""
from pathlib import Path

import click

from kraken_tpu_torch.ketos.util import _load_yaml_config, device_mesh, expand_manifests


def _common_train_options(f):
    opts = [
        click.option('-B', '--batch-size', type=int, default=None, help='Batch size'),
        click.option('--config', callback=_load_yaml_config,
                      is_eager=True, expose_value=False, type=click.Path(exists=True),
                      help='YAML experiment file.'),
        click.option('-o', '--output', type=click.Path(), default='model',
                      help='Output model prefix'),
        click.option('--pad', default=16, type=int,
                      help='Left/right padding around training lines'),
        click.option('--weights-format', default='safetensors',
                      type=click.Choice(['safetensors', 'coreml']),
                      help='Format of the final best-model weights file'),
        click.option('--linetype', default=None,
                      type=click.Choice(['baselines', 'bbox']),
                      help='Line type to parse from XML training data'),
        click.option('--log-dir', default=None, type=click.Path(file_okay=False),
                      help='Directory for experiment logger output'),
        click.option('-s', '--spec', default=None, help='VGSL spec of the network'),
        click.option('-i', '--load', type=click.Path(exists=True), default=None,
                      help='Warm start from weights or checkpoint'),
        click.option('-F', '--freq', default=1.0, type=float,
                      help='Model saving and report frequency in epochs'),
        click.option('-q', '--quit', default='fixed',
                      type=click.Choice(['early', 'fixed']), help='Stop condition'),
        click.option('-N', '--epochs', default=-1, type=int, help='Number of epochs'),
        click.option('--min-epochs', default=0, type=int),
        click.option('--lag', default=10, type=int,
                      help='Epochs to wait before early stopping'),
        click.option('--min-delta', default=0.0, type=float),
        click.option('--optimizer', default=None,
                      type=click.Choice(['Adam', 'AdamW', 'SGD', 'RMSprop', 'Lamb'])),
        click.option('-r', '--lrate', default=None, type=float, help='Learning rate'),
        click.option('-m', '--momentum', default=0.9, type=float),
        click.option('-w', '--weight-decay', default=0.0, type=float),
        click.option('--warmup', default=0, type=int, help='Warmup steps'),
        click.option('--schedule', default='constant',
                      type=click.Choice(['constant', '1cycle', 'exponential', 'cosine',
                                         'step', 'reduceonplateau'])),
        click.option('-g', '--gamma', default=0.1, type=float),
        click.option('-ss', '--step-size', default=10, type=int),
        click.option('--sched-patience', 'rop_patience', default=5, type=int),
        click.option('--cos-max', 'cos_t_max', default=10, type=int),
        click.option('--cos-min-lr', default=1e-6, type=float),
        click.option('-p', '--partition', default=0.9, type=float,
                      help='Train/validation partition'),
        click.option('-u', '--normalization', default=None,
                      type=click.Choice(['NFD', 'NFKD', 'NFC', 'NFKC'])),
        click.option('-n', '--normalize-whitespace/--no-normalize-whitespace', default=True),
        click.option('--reorder/--no-reorder', default=True,
                      help='Reorder code points to display order'),
        click.option('--base-dir', default='auto', type=click.Choice(['L', 'R', 'auto'])),
        # reference names these -t/--training-data and -e/--evaluation-data
        # (kraken/ketos/recognition.py:116-120); the *-files spellings are
        # kept as compatible aliases
        click.option('-t', '--training-data', '--training-files', 'training_files',
                      multiple=True, callback=expand_manifests,
                      type=click.Path(exists=True), help='Manifest of training data'),
        click.option('-e', '--evaluation-data', '--evaluation-files', 'evaluation_files',
                      multiple=True, callback=expand_manifests,
                      type=click.Path(exists=True), help='Manifest of evaluation data'),
        click.option('-f', '--format-type', default='path',
                      type=click.Choice(['path', 'xml', 'alto', 'page', 'binary'])),
        click.option('--augment/--no-augment', default=False),
        click.option('--resize', default='fail', type=click.Choice(['fail', 'union', 'new',
                                                                    'add', 'both'])),
        click.option('-c', '--codec', default=None, type=click.Path(exists=True),
                      help='JSON file with codec definition'),
        click.option('--legacy-polygons', is_flag=True, default=False),
        click.option('--accumulate-grad-batches', default=1, type=int),
        click.option('--gradient-clip-val', default=1.0, type=float),
        click.option('--remat/--no-remat', default=False,
                      help='Rematerialize the forward on backward to save device memory.'),
        click.option('--freeze-backbone', type=int, default=0,
                      help='Number of steps to keep everything but the last layer frozen.'),
        click.option('--fixed-splits/--ignore-fixed-splits', 'binary_dataset_split',
                      default=False),
        click.option('--logger', 'loggers', default=None,
                      type=click.Choice(['tensorboard', 'wandb']),
                      help='Experiment logger backend.'),
        click.option('--resume', default=None, type=click.Path(exists=True),
                      help='Resume training from a checkpoint (weights, optimizer '
                           'state, and epoch counter).'),
        click.option('--devices', type=int, default=1,
                      help='Number of devices for data-parallel training: one process '
                           'a device (NCCL on cuda, gloo on cpu).'),
        click.option('--profile-dir', default=None, type=click.Path(),
                      help='Write a torch.profiler trace of the first epoch to this '
                           'directory (inspect with tensorboard).'),
    ]
    for opt in reversed(opts):
        f = opt(f)
    return f


@click.command('train')
@click.pass_context
@_common_train_options
@click.argument('ground_truth', nargs=-1, type=click.Path(exists=True, dir_okay=False))
def train(ctx, ground_truth, batch_size, output, pad, weights_format, linetype,
          log_dir, spec, load, freq, quit, epochs,
          min_epochs, lag, min_delta, optimizer, lrate, momentum, weight_decay,
          warmup, schedule, gamma, step_size, rop_patience, cos_t_max, cos_min_lr,
          partition, normalization, normalize_whitespace, reorder, base_dir,
          training_files, evaluation_files, format_type, augment, resize, codec,
          legacy_polygons, accumulate_grad_batches, gradient_clip_val, remat,
          freeze_backbone, binary_dataset_split, loggers, resume, profile_dir,
          devices):
    """
    Trains a text recognition model.
    """
    import json
    from kraken_tpu_torch.configs import (RecognitionTrainingConfig,
                                          RecognitionTrainingDataConfig)
    from kraken_tpu_torch.kraken import _resolve_device
    from kraken_tpu_torch.ketos import message
    from kraken_tpu_torch.train import (KrakenTrainer, RecognitionDataModule,
                                        RecognitionModel, convert_checkpoint)

    # 'add'/'both' aliases from kraken < 5
    resize = {'add': 'union', 'both': 'new'}.get(resize, resize)
    training_data = list(ground_truth) + list(training_files or [])
    if not training_data:
        raise click.UsageError('No training data provided.')
    if codec:
        with open(codec) as fp:
            codec = json.load(fp)
    reorder_val = reorder if base_dir == 'auto' else (base_dir if reorder else False)

    kwargs = dict(checkpoint_path=output, freq=freq, quit=quit, epochs=epochs,
                  min_epochs=min_epochs, lag=lag, min_delta=min_delta,
                  momentum=momentum, weight_decay=weight_decay, warmup=warmup,
                  schedule=schedule, gamma=gamma, step_size=step_size,
                  rop_patience=rop_patience, cos_t_max=cos_t_max,
                  cos_min_lr=cos_min_lr, resize=resize,
                  accumulate_grad_batches=accumulate_grad_batches,
                  gradient_clip_val=gradient_clip_val, remat=remat,
                  freeze_backbone=freeze_backbone, weights_format=weights_format,
                  loggers=loggers, profile_dir=profile_dir,
                  device=_resolve_device(ctx.meta['device']), precision=ctx.meta['precision'])
    if devices != 1:
        kwargs['devices'] = devices
    if spec:
        kwargs['spec'] = spec
    if lrate is not None:
        kwargs['lrate'] = lrate
    if optimizer:
        kwargs['optimizer'] = optimizer
    config = RecognitionTrainingConfig(**kwargs)
    data_config = RecognitionTrainingDataConfig(
        training_data=training_data,
        evaluation_data=list(evaluation_files) or None,
        partition=partition,
        format_type=format_type,
        normalization=normalization,
        normalize_whitespace=normalize_whitespace,
        reorder=reorder_val,
        augment=augment,
        codec=codec,
        pad=pad,
        linetype=linetype,
        binary_dataset_split=binary_dataset_split,
        batch_size=batch_size or 1,
        num_workers=ctx.meta['workers'])
    data_config.legacy_polygons = legacy_polygons

    dm = RecognitionDataModule(data_config)
    module = (RecognitionModel.load_from_weights(config, load) if load
              else RecognitionModel(config))
    with device_mesh(devices, config.device) as mesh:
        trainer = KrakenTrainer(config, mesh=mesh, log_dir=log_dir)
        trainer.fit(module, dm, resume=resume)
    best = trainer._ckpt_path('best')
    if trainer.is_main and best.exists():
        ext = '.mlmodel' if weights_format == 'coreml' else '.safetensors'
        out = Path(f'{output}_best{ext}')
        convert_checkpoint(best, out, format=weights_format)
        message(f'Best model written to {out}')




@click.command('test')
@click.pass_context
@click.option('-m', '--model', multiple=True, type=click.Path(exists=True),
              help='Model(s) to evaluate')
@click.option('-B', '--batch-size', type=int, default=1)
@click.option('-e', '--test-data', '--evaluation-files', 'evaluation_files',
              multiple=True, callback=expand_manifests,
              type=click.Path(exists=True))
@click.option('-f', '--format-type', default='path',
              type=click.Choice(['path', 'xml', 'alto', 'page', 'binary']))
@click.option('-u', '--normalization', default=None,
              type=click.Choice(['NFD', 'NFKD', 'NFC', 'NFKC']))
@click.option('-n', '--normalize-whitespace/--no-normalize-whitespace', default=True)
@click.option('--reorder/--no-reorder', default=True)
@click.option('--base-dir', default='auto', type=click.Choice(['L', 'R', 'auto']))
@click.option('--pad', default=16, type=int,
              help='Left/right padding around lines')
@click.option('--linetype', default=None, type=click.Choice(['baselines', 'bbox']))
@click.option('--fixed-splits/--ignore-fixed-splits', 'binary_dataset_split', default=False)
@click.option('--no-legacy-polygons', is_flag=True, default=False,
              help='Force disable the legacy polygon extractor.')
@click.argument('test_data', nargs=-1, type=click.Path(exists=True, dir_okay=False))
def test(ctx, model, batch_size, evaluation_files, format_type, normalization,
         normalize_whitespace, reorder, base_dir, pad, linetype,
         binary_dataset_split, no_legacy_polygons, test_data):
    """
    Evaluates recognition model(s) on a test set, printing an accuracy report.
    """
    from kraken_tpu_torch.configs import (RecognitionTrainingConfig,
                                          RecognitionTrainingDataConfig)
    from kraken_tpu_torch.serialization import render_report
    from kraken_tpu_torch.train import RecognitionDataModule, RecognitionModel

    from kraken_tpu_torch.kraken import _resolve_device
    device = _resolve_device(ctx.meta['device'])
    if not model:
        raise click.UsageError('No model(s) given (-m).')
    files = list(test_data) + list(evaluation_files or [])
    if not files:
        raise click.UsageError('No test data provided.')
    for m in model:
        config = RecognitionTrainingConfig(device=device,
                                           precision=ctx.meta['precision'])
        module = RecognitionModel.load_from_weights(config, m)
        # legacy polygon extraction follows the model's training-time flag
        # unless force-disabled (reference: ketos/recognition.py:337-340)
        data_config = RecognitionTrainingDataConfig(
            test_data=files, format_type=format_type,
            normalization=normalization,
            normalize_whitespace=normalize_whitespace,
            reorder=reorder if base_dir == 'auto' else (base_dir if reorder else False),
            pad=pad,
            linetype=linetype,
            binary_dataset_split=binary_dataset_split,
            legacy_polygons=not no_legacy_polygons and module.net.use_legacy_polygons,
            batch_size=batch_size,
            num_workers=ctx.meta['workers'])
        dm = RecognitionDataModule(data_config)
        dm.setup('test')
        module.setup('test', dm)
        metrics = module.test(dm)
        click.echo(render_report(str(m), metrics['chars'], metrics['errors'],
                                 metrics['accuracy'], metrics['case_insensitive_accuracy'],
                                 metrics['word_accuracy'], metrics['confusions'],
                                 metrics['scripts'], metrics['insertions'],
                                 metrics['deletions'], metrics['substitutions']))
