"""
kraken_tpu_torch.lib.telemetry
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

Host-to-device transfer accounting, a copy of the JAX package's
``lib/telemetry.py``.

The inference paths call :func:`record_up` / :func:`record_down` with the
payload byte counts at every device boundary crossing (recognition batch
uploads, the resident page buffers of device line extraction,
segmentation page uploads, heatmap and decode-tensor downloads). The calls
are no-ops unless a collector is active, so production code pays one
attribute load per dispatch.

``chip_smoke.py`` reads it for the bytes up a page of each recognition
input route (``input_transfer``, ``line_extraction``).
"""
import contextlib
from dataclasses import dataclass

__all__ = ['TransferStats', 'collect', 'record_up', 'record_down']

_active: list = []


@dataclass
class TransferStats:
    """Byte/call counters for one collection scope."""
    up_bytes: int = 0
    down_bytes: int = 0
    up_calls: int = 0
    down_calls: int = 0

    def as_dict(self, pages: int = 1) -> dict:
        per = max(pages, 1)
        return {'up_mb_per_page': round(self.up_bytes / per / 1e6, 3),
                'down_mb_per_page': round(self.down_bytes / per / 1e6, 3),
                'up_calls': self.up_calls,
                'down_calls': self.down_calls,
                'up_calls_per_page': round(self.up_calls / per, 1),
                'down_calls_per_page': round(self.down_calls / per, 1)}


def record_up(nbytes: int) -> None:
    """Accounts a host->device payload of `nbytes` to active collectors."""
    for s in _active:
        s.up_bytes += nbytes
        s.up_calls += 1


def record_down(nbytes: int) -> None:
    """Accounts a device->host payload of `nbytes` to active collectors."""
    for s in _active:
        s.down_bytes += nbytes
        s.down_calls += 1


@contextlib.contextmanager
def collect():
    """Context manager yielding a TransferStats that accumulates every
    device-boundary transfer recorded while the scope is active. Scopes
    nest (each transfer is accounted to all active collectors)."""
    stats = TransferStats()
    _active.append(stats)
    try:
        yield stats
    finally:
        _active.remove(stats)
