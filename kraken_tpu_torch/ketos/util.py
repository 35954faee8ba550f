"""
kraken_tpu_torch.ketos.util
~~~~~~~~~~~~~~~~~~~~~~~~~~~

Shared ketos CLI helpers (reference: kraken/ketos/util.py), copies of the
JAX package's: YAML experiment file loading, manifest expansion and class
map parsing; and ``device_mesh``, the process group of ``--devices N``
training (the JAX package's ``build_device_mesh``, one process a card).
"""
import contextlib
import logging
import os

logger = logging.getLogger('kraken')

__all__ = ['_load_yaml_config', 'expand_manifests', 'build_device_mesh', 'device_mesh',
           'create_class_map']


def _load_yaml_config(ctx, param, value):
    """
    Eager --config callback seeding click's default map from a YAML file.

    Accepts both flat option maps and the reference's experiment-file shape
    (reference: kraken/ketos/util.py:87, experiments/*.yaml): top-level
    global options plus per-subcommand sections like `train: {...}`. On the
    `ketos` group the whole nested map is installed (click routes sections
    named after subcommands to them); on a subcommand only its own section
    plus scalar globals apply.
    """
    if not value:
        return value
    import yaml
    with open(value, 'r') as fp:
        config = yaml.safe_load(fp) or {}
    cmd = ctx.command
    import click as _click
    if isinstance(cmd, _click.Group):
        flat = dict(config)
    else:
        flat = {}
        for k, v in config.items():
            if isinstance(v, dict):
                if cmd is not None and k == cmd.name:
                    flat.update(v)
            else:
                flat[k] = v
    ctx.default_map = {**(ctx.default_map or {}), **flat}
    return value


def expand_manifests(ctx, param, value):
    """Reads file lists from manifest files (one path per line)."""
    files = []
    for manifest in value:
        with open(manifest, 'r') as fp:
            files.extend(line.strip() for line in fp if line.strip())
    return files


def build_device_mesh(n_devices: int, device: str):
    """
    The process group of ``--devices N`` data-parallel training on
    `device` (``cuda``: NCCL, rank r on ``cuda:r``; ``cpu``: gloo):
    ``(world, ranks)``, the world None for one device (a single process
    needs no group) and ranks the :class:`parallel.launch.Ranks` this
    process started, or None.

    Started by hand, this process becomes rank 0 and starts ranks 1..N-1
    running the same command line (``python -m kraken_tpu_torch.ketos
    ...``) with ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and
    ``MASTER_PORT`` set; a process that finds them set (one of those ranks,
    or one ``torchrun`` started) joins as that rank and starts none. Fewer
    visible cards than asked for are a usage error: the run never trains on
    fewer ranks or on the CPU instead.
    """
    if not n_devices or n_devices <= 1:
        return None, None
    import click
    import torch
    from kraken_tpu_torch.parallel import init_world, world_from_env
    from kraken_tpu_torch.parallel.launch import GRACE_S, free_port, start_ranks

    dev = torch.device(device)
    if dev.type == 'cuda':
        if dev.index is not None:
            raise click.UsageError(f'--devices {n_devices} puts rank r on cuda:r; pass '
                                   f'--device cuda, not {device}.')
        available = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if available < n_devices:
            raise click.UsageError(
                f'--devices {n_devices} requested but only {available} CUDA device(s) are '
                'visible.')
    elif dev.type != 'cpu':
        raise click.UsageError(f'--devices {n_devices} runs on cuda or cpu, not {device}.')
    if 'RANK' in os.environ and 'WORLD_SIZE' in os.environ:
        if int(os.environ['WORLD_SIZE']) != n_devices:
            raise click.UsageError(f'--devices {n_devices} in a world of '
                                   f'{os.environ["WORLD_SIZE"]} processes.')
        return world_from_env(dev.type), None
    argv = click.get_current_context().find_root().meta.get('argv')
    if argv is None:
        raise click.UsageError('--devices N > 1 needs the ketos command line to start its ranks.')
    port = free_port()
    ranks = start_ranks(['-m', 'kraken_tpu_torch.ketos', *argv], n_devices,
                        range(1, n_devices), port)
    # watched from the start: the rendezvous waits for a rank that died
    # before it joined until the group's timeout
    ranks.watch()
    try:
        world = init_world(n_devices, 0, port, device=dev.type)
    except BaseException as err:
        with contextlib.suppress(TimeoutError):
            _wait_ranks(ranks, GRACE_S, err)
        raise
    return world, ranks


def _wait_ranks(ranks, timeout_s, cause=None) -> None:
    """Waits for the ranks this process started (:meth:`Ranks.wait`); the
    first that failed fails the command, with its exit code and the end of
    its standard error, chained from this rank's own error `cause` (a
    peer's collective fails when a rank dies, so `cause` is often only its
    echo)."""
    import click
    from kraken_tpu_torch.parallel.launch import RankFailed
    try:
        ranks.wait(timeout_s)
    except RankFailed as failure:
        exc = click.ClickException(str(failure))
        exc.exit_code = failure.exit_code
        raise exc from (cause or failure)


@contextlib.contextmanager
def device_mesh(n_devices: int, device: str):
    """:func:`build_device_mesh`'s world for the body of a training command;
    the group is left at its end, and rank 0 then waits for the ranks it
    started. A rank that failed fails the command with its exit code and the
    end of its standard error, also where this rank failed first: then the
    ranks get GRACE_S seconds to show a failure before they are stopped and
    this rank's own error stands."""
    from kraken_tpu_torch.parallel.launch import GRACE_S
    world, ranks = build_device_mesh(n_devices, device)
    try:
        yield world
    except BaseException as err:
        if ranks is not None:
            with contextlib.suppress(TimeoutError):
                _wait_ranks(ranks, GRACE_S, err)
        raise
    finally:
        if world is not None:
            world.close()
    if ranks is not None:
        _wait_ranks(ranks, None)


def create_class_map(cls_map):
    """
    Converts a config-file class mapping — a dict or a list of
    (class, label) pairs, optionally with a '*' wildcard default — into the
    mapping consumed by the segmentation datasets (reference:
    kraken/ketos/util.py _create_class_map).
    """
    from collections import defaultdict
    if isinstance(cls_map, dict):
        return dict(cls_map)
    pairs = [tuple(p) for p in cls_map]
    default = None
    for idx, (cls, label) in enumerate(pairs):
        if '*' in cls:
            default = (lambda lab: (lambda: lab))(label)
            pairs.pop(idx)
            break
    return defaultdict(default, pairs)
