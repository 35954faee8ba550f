#!/usr/bin/env python
"""
Renders BaselineSet training targets (baseline strips plus start/end
separator patches) as semi-transparent overlays next to the source images,
for inspecting what the segmentation trainer sees (reference:
kraken/contrib/baselineset_overlay.py), the counterpart of the JAX
package's contrib script. Runs no model; needs ``lxml``:

    python -m kraken_tpu_torch.contrib.baselineset_overlay page.xml

Beside each page image it writes ``<image>.heat.<class>.png`` for every
baseline class and the start and end separators, and
``<image>.overlay.png``. The class mapping is built by scanning the input
pages instead of a hard-coded 'default' class.
"""
import click


@click.command()
@click.option('--line-width', default=4, help='Baseline strip width in target space.')
@click.argument('files', nargs=-1, type=click.Path(exists=True))
def cli(line_width, files):
    from os.path import splitext

    from PIL import Image

    from kraken_tpu_torch.dataset import ImageInputTransforms
    from kraken_tpu_torch.dataset.segmentation import BaselineSet
    from kraken_tpu_torch.xml import XMLPage

    transforms = ImageInputTransforms(1, 1200, 0, 3, 0, valid_norm=False)

    pages = [XMLPage(f).to_container() for f in files]
    baseline_tags = sorted({t for p in pages for line in p.lines
                            for t in ([v[0]['type'] if isinstance(v, list) else v
                                       for k, v in (line.tags or {}).items() if k == 'type']
                                      or ['default'])})
    region_tags = sorted({k for p in pages for k in p.regions})
    class_mapping = {
        'aux': {'_deleted': 0, '_start_separator': 1, '_end_separator': 2},
        'baselines': {t: 3 + i for i, t in enumerate(baseline_tags)},
        'regions': {t: 3 + len(baseline_tags) + i for i, t in enumerate(region_tags)},
    }
    ds = BaselineSet(class_mapping, im_transforms=transforms, line_width=line_width)
    for page in pages:
        ds.add(page)

    colors = [(0, 130, 200), (230, 25, 75), (60, 180, 75), (255, 225, 25),
              (245, 130, 48), (145, 30, 180), (70, 240, 240)]

    for idx in range(len(ds.imgs)):
        sample = ds[idx]
        name = str(ds.imgs[idx])
        click.echo(name)
        target = sample['target']
        arr = (sample['image'].transpose(1, 2, 0) * 255).astype('uint8')
        im = Image.fromarray(arr.squeeze() if arr.shape[2] == 1 else arr).convert('RGBA')
        channels = ([(cls, f'baseline:{t}') for t, cls in class_mapping['baselines'].items()]
                    + [(1, 'start'), (2, 'end')])
        for n, (cls, label) in enumerate(channels):
            heat = Image.fromarray((target[cls] * 255).astype('uint8'))
            heat.save(f'{splitext(name)[0]}.heat.{cls}.png')
            overlay = Image.new('RGBA', im.size, colors[n % len(colors)] + (255,))
            im = Image.composite(overlay, im, heat)
        im.save(splitext(name)[0] + '.overlay.png')


if __name__ == '__main__':
    cli()
