"""
kraken_tpu_torch.ketos
~~~~~~~~~~~~~~~~~~~~~~

The ``ketos`` command line tool of the port (reference: kraken/ketos/),
the counterpart of the JAX package's ``ketos``:

    python -m kraken_tpu_torch.ketos [-d cpu] <command> ...

The commands that run a model (``test``, ``segtest``) run on the card:
``--device`` defaults to ``cuda`` and such a run without a card stops with
a usage error unless it asks for ``--device cpu``.
The commands that train nothing are here: ``convert`` (checkpoints and
weights to a weights file), ``roadd`` (a reading-order model into a
segmentation model's file), ``compile`` (an Arrow dataset; needs
``pyarrow``, and ``lxml`` for XML input), ``test`` (a recognition model's
accuracy report; ``-f binary`` needs ``pyarrow``, ``-f xml`` ``lxml``) and
``segtest`` (a segmentation model's metrics; needs ``lxml``). ``train``,
``segtrain`` and ``rotrain`` (ROADMAP.md queue 1 item 9b) and
``pretrain`` (item 11) are usage errors until their items land;
``publish`` talks to the model repository over the network and is not
ported, by decision.
"""
import logging
import warnings

import click

from kraken_tpu_torch import __version__
from kraken_tpu_torch.lib import log

warnings.simplefilter('ignore', UserWarning)
logging.captureWarnings(True)
logger = logging.getLogger('kraken')


def message(msg: str, **styles) -> None:
    if logger.getEffectiveLevel() >= 30:
        click.secho(msg, **styles)


from kraken_tpu_torch.ketos.util import _load_yaml_config  # noqa: E402


@click.group(context_settings=dict(show_default=True))
@click.version_option(version=__version__, prog_name='ketos')
@click.option('-v', '--verbose', default=0, count=True)
@click.option('-s', '--seed', default=None, type=click.INT,
              help='Seed for numpy and torch RNGs.')
@click.option('-d', '--device', default='cuda',
              help='Select device to use (cuda, cuda:0, ..., cpu).')
@click.option('--precision', type=click.Choice(['64', '32', 'bf16', '16']),
              default='32', help='Numerical precision.')
@click.option('--workers', default=1, type=click.IntRange(0),
              help='Number of data loading workers.')
@click.option('--threads', default=1, type=click.IntRange(1),
              help='Size of host thread pools.')
@click.option('--config', callback=_load_yaml_config, is_eager=True,
              expose_value=False, type=click.Path(exists=True),
              help='YAML experiment file with global options and per-command sections.')
def cli(verbose, seed, device, precision, workers, threads):
    """
    Training and dataset tooling.
    """
    ctx = click.get_current_context()
    if seed is not None:
        import numpy as np
        import torch
        np.random.seed(seed)
        torch.manual_seed(seed)
    ctx.meta['verbose'] = verbose
    ctx.meta['device'] = device
    ctx.meta['precision'] = {'64': '64-true', '32': '32-true',
                             'bf16': 'bf16-true', '16': '16-true'}[precision]
    ctx.meta['workers'] = workers
    ctx.meta['threads'] = threads
    log.set_logger(logger, level=30 - min(10 * verbose, 20))


def _not_yet(name: str, item: str):
    """A command of the JAX ketos whose port waits for a ROADMAP item: any
    call is a usage error that names it."""
    @click.command(name, context_settings=dict(ignore_unknown_options=True,
                                               allow_extra_args=True, help_option_names=[]))
    def command():
        raise click.UsageError(f'ketos {name} is not ported yet: ROADMAP.md queue 1 item {item}.')
    command.help = f'Not ported yet (ROADMAP.md queue 1 item {item}).'
    return command


from kraken_tpu_torch.ketos import dataset, recognition, ro, segmentation, weights  # noqa: E402

cli.add_command(recognition.test)
cli.add_command(segmentation.segtest)
cli.add_command(ro.roadd)
cli.add_command(dataset.compile)
cli.add_command(weights.convert)
for _name, _item in (('train', '9b'), ('segtrain', '9b'), ('rotrain', '9b'), ('pretrain', '11')):
    cli.add_command(_not_yet(_name, _item))


if __name__ == '__main__':
    cli()
