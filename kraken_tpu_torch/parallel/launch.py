"""
kraken_tpu_torch.parallel.launch
~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~~

Starting the processes of a data-parallel run on one machine: a free port
on the loopback for the rendezvous, and ranks started as new Python
processes with ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``
in their environment (``torchrun``'s names). The caller waits for them with
:meth:`Ranks.wait`; a rank that fails fails the run, with its exit code and
the end of its standard error.
"""
import os
import socket
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional, Sequence

__all__ = ['free_port', 'start_ranks', 'Ranks', 'RankFailed', 'GRACE_S']

# the package's parent directory, put on a rank's PYTHONPATH so that it
# imports this package wherever it starts
_ROOT = str(Path(__file__).resolve().parents[2])
# the stderr bytes of a failed rank that its error keeps
TAIL_BYTES = 4000
# how long the process that started the ranks gives a rank's failure to
# reach it (gloo: through its own collective's error) before it ends the
# run, and, after its own error, the ranks to show theirs
GRACE_S = 5.0


def free_port() -> int:
    """A TCP port on 127.0.0.1 that nothing listens on (bound once at port
    0 and released)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


class RankFailed(RuntimeError):
    """A started rank exited with a non-zero code."""

    def __init__(self, rank: int, code: int, tail: str):
        self.rank, self.code, self.tail = rank, code, tail
        super().__init__(f'rank {rank} exited with code {code}; the end of its stderr:\n{tail}')

    @property
    def exit_code(self) -> int:
        """The code the run ends with: the rank's own, or the shell's 128 +
        signal where a signal ended it."""
        return self.code if self.code > 0 else 128 - self.code


class Ranks:
    """The processes of the ranks one process started, each writing its
    standard error to a file of its own."""

    def __init__(self, procs: dict, logs: dict, tmp):
        self.procs, self.logs, self._tmp = procs, logs, tmp
        self._done = threading.Event()
        self._lock = threading.Lock()
        self._closed = False

    def failed(self) -> Optional[RankFailed]:
        """The first rank that has exited with a non-zero code, if any."""
        with self._lock:
            if self._closed:
                return None
            for rank, proc in self.procs.items():
                code = proc.poll()
                if code not in (None, 0):
                    data = Path(self.logs[rank].name).read_bytes()
                    return RankFailed(rank, code, data[-TAIL_BYTES:].decode('utf-8', 'replace'))
        return None

    def wait(self, timeout_s: Optional[float] = None) -> None:
        """Waits for every rank to end, `timeout_s` at most. Raises
        :class:`RankFailed` for the first rank that fails, and
        ``TimeoutError`` when they have not all ended in time; either way it
        first stops those still running. Called once: it removes the ranks'
        logs."""
        self._done.set()
        end = None if timeout_s is None else time.monotonic() + timeout_s
        try:
            while True:
                ended = all(p.poll() is not None for p in self.procs.values())
                failure = self.failed()
                if failure is not None:
                    raise failure
                if ended:
                    return
                if end is not None and time.monotonic() > end:
                    raise TimeoutError(f'the ranks did not end within {timeout_s} s')
                time.sleep(0.1)
        finally:
            with self._lock:
                for proc in self.procs.values():
                    if proc.poll() is None:
                        proc.kill()
                        proc.wait()
                for log in self.logs.values():
                    log.close()
                self._tmp.cleanup()
                self._closed = True

    def watch(self) -> None:
        """Ends this process and the ranks left, with a failed rank's exit
        code, when that rank fails and this process has not begun to
        :meth:`wait` GRACE_S seconds later: the rendezvous, and a collective
        on NCCL, wait for a dead rank until the group's timeout, where gloo's
        collectives raise at once."""
        def run():
            while not self._done.wait(0.5):
                failure = self.failed()
                if failure is not None and not self._done.wait(GRACE_S):
                    for proc in self.procs.values():
                        if proc.poll() is None:
                            proc.kill()
                    print(f'Error: {failure}', file=sys.stderr, flush=True)
                    os._exit(failure.exit_code)
        threading.Thread(target=run, daemon=True).start()


def start_ranks(argv: Sequence[str], world_size: int, ranks: Sequence[int], port: int,
                env: Optional[dict] = None) -> Ranks:
    """Starts ``python <argv>`` once for each rank of `ranks` in a world of
    `world_size` meeting at 127.0.0.1:`port`, in this process's working
    directory."""
    tmp = tempfile.TemporaryDirectory(prefix='kraken-ranks-')
    procs, logs = {}, {}
    base = dict(os.environ if env is None else env)
    base['PYTHONPATH'] = os.pathsep.join(p for p in (_ROOT, base.get('PYTHONPATH')) if p)
    try:
        for rank in ranks:
            rank_env = dict(base, RANK=str(rank), LOCAL_RANK=str(rank),
                            WORLD_SIZE=str(world_size), MASTER_ADDR='127.0.0.1',
                            MASTER_PORT=str(port))
            logs[rank] = open(Path(tmp.name) / f'rank{rank}.err', 'w+b')
            procs[rank] = subprocess.Popen([sys.executable, *argv], env=rank_env,
                                           stderr=logs[rank])
    except BaseException:
        for proc in procs.values():
            proc.kill()
        tmp.cleanup()
        raise
    return Ranks(procs, logs, tmp)
