"""
ketos test (reference: kraken/ketos/recognition.py), the counterpart of the
JAX package's: evaluates recognition models on a test set on ``--device``
and prints the accuracy report. ``train`` waits for ROADMAP.md queue 1
item 9b.
"""
import click

from kraken_tpu_torch.ketos.util import expand_manifests


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
