"""
kraken_tpu_torch.ketos.util
~~~~~~~~~~~~~~~~~~~~~~~~~~~

Shared ketos CLI helpers (reference: kraken/ketos/util.py), copies of the
JAX package's: YAML experiment file loading, manifest expansion and class
map parsing. ``build_device_mesh`` waits for ROADMAP.md queue 1 item 10
(multi-GPU).
"""
import logging

logger = logging.getLogger('kraken')

__all__ = ['_load_yaml_config', 'expand_manifests', 'create_class_map']


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
