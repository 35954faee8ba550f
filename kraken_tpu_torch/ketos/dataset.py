"""
ketos compile (reference: kraken/ketos/dataset.py), the counterpart of the
JAX package's: compiles XML or path ground truth into a binary Arrow
dataset (needs ``pyarrow``; XML input needs ``lxml``), with the rich
progress bar of ``lib/progress.py``.
"""
import click

from kraken_tpu_torch.ketos.util import expand_manifests


@click.command('compile')
@click.pass_context
@click.option('-o', '--output', type=click.Path(), default='dataset.arrow')
@click.option('-f', '--format-type', default='xml',
              type=click.Choice(['xml', 'alto', 'page', 'path']))
@click.option('-F', '--files', multiple=True, callback=expand_manifests,
              type=click.Path(exists=True), help='Manifest of input files.')
@click.option('--random-split', type=float, nargs=3, default=None,
              help='Random (train, validation, test) split proportions.')
@click.option('--force-type', default=None,
              type=click.Choice(['kraken_recognition_baseline', 'kraken_recognition_bbox']))
@click.option('--save-splits/--ignore-splits', default=True,
              help='Serialize explicit splits from the source data.')
@click.option('--skip-empty-lines/--keep-empty-lines', default=True)
@click.option('--recordbatch-size', default=100, type=int)
@click.option('--legacy-polygons', is_flag=True, default=False)
@click.option('--linetype', type=click.Choice(['baselines', 'bbox']), default=None,
              help='Line data extracted from XML sources: polygon-dewarped '
                   'baselines (default) or plain bounding-box crops.')
@click.argument('ground_truth', nargs=-1, type=click.Path(exists=True, dir_okay=False))
def compile(ctx, output, format_type, files, random_split, force_type,
            save_splits, skip_empty_lines, recordbatch_size, legacy_polygons,
            linetype, ground_truth):
    """
    Compiles datasets into a binary Arrow format.
    """
    from kraken_tpu_torch.dataset.arrow import build_binary_dataset
    from kraken_tpu_torch.ketos import message
    from kraken_tpu_torch.lib.progress import KrakenProgressBar

    inputs = list(ground_truth) + list(files or [])
    if not inputs:
        raise click.UsageError('No input data provided.')
    with KrakenProgressBar() as progress:
        task = progress.add_task('Compiling dataset', total=0)

        def _update(advance, total):
            progress.update(task, total=total, advance=advance)

        build_binary_dataset(files=inputs,
                             output_file=output,
                             format_type=format_type,
                             num_workers=ctx.meta['workers'],
                             ignore_splits=not save_splits,
                             random_split=tuple(random_split) if random_split else None,
                             force_type=force_type,
                             recordbatch_size=recordbatch_size,
                             skip_empty_lines=skip_empty_lines,
                             callback=_update,
                             linetype=linetype,
                             legacy_polygons=legacy_polygons)
    message(f'Output file written to {output}')
