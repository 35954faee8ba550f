"""
kraken_tpu_torch.lib.progress
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

The rich-based progress bar of ``ketos compile`` (reference:
kraken/lib/progress.py), a copy of the JAX package's ``KrakenProgressBar``;
without ``rich`` the bar does nothing.
"""

__all__ = ['KrakenProgressBar']

try:
    from rich.progress import (BarColumn, Progress, TextColumn, TimeElapsedColumn,
                               TimeRemainingColumn)

    class KrakenProgressBar(Progress):
        """Progress bar with task description, percentage, and timings."""

        def __init__(self, *args, **kwargs):
            columns = [TextColumn('[progress.description]{task.description}'),
                       BarColumn(),
                       TextColumn('[progress.percentage]{task.percentage:>3.0f}%'),
                       TimeRemainingColumn(),
                       TimeElapsedColumn()]
            kwargs['refresh_per_second'] = 1
            super().__init__(*columns, *args, **kwargs)

except ImportError:
    class KrakenProgressBar:
        """A progress bar that shows nothing."""

        def __init__(self, *args, **kwargs):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *args):
            return False

        def add_task(self, *args, **kwargs):
            return 0

        def update(self, *args, **kwargs):
            pass
