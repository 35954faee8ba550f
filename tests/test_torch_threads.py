"""
The thread share of the port's CPU tests.

Under pytest-xdist every worker is a process of its own, and torch gives
each of them as many intra-op threads as the machine has cores: six
workers on eight cores run 48 threads, and a training test that takes
seconds alone takes minutes among them. Every ``tests/test_torch_*.py``
imports this module first; when ``PYTEST_XDIST_WORKER_COUNT`` is set, it
gives each worker's torch ``cpu_count // workers`` threads (at least one),
and :func:`subprocess_env` hands the same share to the interpreters the
tests start (``OMP_NUM_THREADS``). Without xdist nothing changes.
"""
import os
from typing import Optional

import pytest
import torch


def thread_share(workers: Optional[str], cores: Optional[int]) -> Optional[int]:
    """A worker's threads: ``cores // workers``, at least 1; None without
    a worker count."""
    if not workers:
        return None
    return max(1, (cores or 1) // int(workers))


THREADS = thread_share(os.environ.get('PYTEST_XDIST_WORKER_COUNT'), os.cpu_count())
if THREADS is not None:
    torch.set_num_threads(THREADS)


def subprocess_env() -> dict:
    """The environment for a Python the tests start: this one's, with
    ``OMP_NUM_THREADS`` at the worker's share under xdist."""
    env = dict(os.environ)
    if THREADS is not None:
        env['OMP_NUM_THREADS'] = str(THREADS)
    return env


@pytest.mark.parametrize('workers, cores, threads', [(None, 8, None), ('', 8, None), ('6', 8, 1),
                                                     ('4', 8, 2), ('1', 8, 8), ('12', 8, 1),
                                                     ('2', None, 1)])
def test_thread_share(workers, cores, threads):
    assert thread_share(workers, cores) == threads


def test_share_applied():
    """This process's torch runs the share under xdist, and the
    interpreters the tests start are told the same."""
    workers = os.environ.get('PYTEST_XDIST_WORKER_COUNT')
    if workers:
        assert torch.get_num_threads() == max(1, os.cpu_count() // int(workers)) == THREADS
        assert subprocess_env()['OMP_NUM_THREADS'] == str(THREADS)
    else:
        assert THREADS is None
        assert subprocess_env().get('OMP_NUM_THREADS') == os.environ.get('OMP_NUM_THREADS')
