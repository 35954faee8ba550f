"""
kraken_tpu_torch.ketos
~~~~~~~~~~~~~~~~~~~~~~

The ``ketos`` command line tool of the port (reference: kraken/ketos/),
the counterpart of the JAX package's ``ketos``:

    python -m kraken_tpu_torch.ketos [-d cpu] <command> ...

The commands that run a model (``train``, ``segtrain``, ``rotrain``,
``pretrain``, ``test``, ``segtest``) run on the card: ``--device`` defaults
to ``cuda`` and such a run without a card stops with a usage error unless
it asks for ``--device cpu``. ``train`` (a recognition model; ``-f path``
line images with ``.gt.txt``, ``-f xml`` pages (``lxml``), ``-f binary``
Arrow files (``pyarrow``)), ``segtrain`` (a baseline segmentation model,
XML pages), ``rotrain`` (a neural reading-order model, XML pages) and
``pretrain`` (a recognition backbone, contrastively, from untranscribed
lines; ``-f binary`` by default) train in float32 and write checkpoints,
on ``--devices N`` processes with one card each (gloo ranks with ``-d
cpu``);
``convert`` (checkpoints and weights to a weights file), ``roadd`` (a
reading-order model into a segmentation model's file), ``compile`` (an
Arrow dataset; needs ``pyarrow``, and ``lxml`` for XML input), ``test`` (a
recognition model's accuracy report; ``-f binary`` needs ``pyarrow``,
``-f xml`` ``lxml``) and ``segtest`` (a segmentation model's metrics;
needs ``lxml``). ``publish`` uploads a model and its metadata card to the
model repository through the optional ``htrmopo`` package; it loads the
model on the host to check it, reads no device, and exits 1 with the
repository's message when ``htrmopo`` is missing or the upload fails.
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


class _Ketos(click.Group):
    """The ketos group; keeps its command line in ``ctx.meta['argv']``, from
    which ``--devices N`` starts its other ranks."""

    def make_context(self, info_name, args, parent=None, **extra):
        argv = list(args)
        ctx = super().make_context(info_name, args, parent=parent, **extra)
        ctx.meta['argv'] = argv
        return ctx


@click.group(cls=_Ketos, context_settings=dict(show_default=True))
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


from kraken_tpu_torch.ketos import (dataset, pretrain, recognition, repo, ro,  # noqa: E402
                                    segmentation, weights)

cli.add_command(recognition.train)
cli.add_command(recognition.test)
cli.add_command(segmentation.segtrain)
cli.add_command(segmentation.segtest)
cli.add_command(ro.rotrain)
cli.add_command(ro.roadd)
cli.add_command(dataset.compile)
cli.add_command(weights.convert)
cli.add_command(pretrain.pretrain)
cli.add_command(repo.publish)


if __name__ == '__main__':
    cli()
