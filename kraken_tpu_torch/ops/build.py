"""
kraken_tpu_torch.ops.build
~~~~~~~~~~~~~~~~~~~~~~~~~~

Builds the hand-written CUDA kernels of ``kraken_tpu_torch/csrc`` and binds
them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own with
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC``
into ``kraken_tpu_torch/_build/lib<name>.so``. A library is built at its
first use and rebuilt when any file under ``csrc`` (its source or a header)
is newer than it; :func:`build_all` starts one ``nvcc`` per source, all at
once. There is no fallback: without ``nvcc`` or on a compile error the
build raises.
"""
import ctypes
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

__all__ = ['load_library', 'build_all', 'SOURCE_DIR', 'BUILD_DIR']

SOURCE_DIR = Path(__file__).resolve().parent.parent / 'csrc'
BUILD_DIR = Path(__file__).resolve().parent.parent / '_build'

NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17', '-O3',
              '-shared', '-Xcompiler', '-fPIC']

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which('nvcc')
    if nvcc is None:
        cuda_home = os.environ.get('CUDA_HOME', '/usr/local/cuda')
        candidate = Path(cuda_home) / 'bin' / 'nvcc'
        if candidate.is_file():
            nvcc = str(candidate)
    if nvcc is None:
        raise RuntimeError('nvcc not found (neither on PATH nor under CUDA_HOME); '
                           'the CUDA kernels of kraken_tpu_torch cannot be built')
    return nvcc


def _paths(name: str) -> tuple[Path, Path]:
    src = SOURCE_DIR / f'{name}.cu'
    if not src.is_file():
        raise FileNotFoundError(f'no kernel source {src}')
    return src, BUILD_DIR / f'lib{name}.so'


def _stale(lib: Path) -> bool:
    """A library is stale when it is missing or older than any source under
    ``csrc`` (a ``.cu`` or a header it may include)."""
    if not lib.is_file():
        return True
    built = lib.stat().st_mtime
    return any(p.stat().st_mtime > built for p in SOURCE_DIR.iterdir() if p.is_file())


def _start(name: str) -> Optional[tuple[subprocess.Popen, Path, Path]]:
    """Starts nvcc for a stale library; returns None when it is current."""
    src, lib = _paths(name)
    if not _stale(lib):
        return None
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc, *NVCC_FLAGS, '-o', tmp, str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    return proc, Path(tmp), lib


def _finish(job: tuple[subprocess.Popen, Path, Path]) -> None:
    proc, tmp, lib = job
    out, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'nvcc failed for {lib.name} (exit {proc.returncode}):\n'
                           f'{out.decode(errors="replace")}')
    os.replace(tmp, lib)


def build_all() -> list[str]:
    """
    Builds every stale kernel library, one nvcc process per source, all
    started together. Returns the names of the kernels in ``csrc``.
    """
    names = sorted(p.stem for p in SOURCE_DIR.glob('*.cu'))
    with _LOCK:
        jobs = [job for job in (_start(n) for n in names) if job is not None]
        errors = []
        for job in jobs:
            try:
                _finish(job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError('\n'.join(errors))
    return names


def load_library(name: str) -> ctypes.CDLL:
    """Returns the ctypes handle of ``lib<name>.so``, building it if stale."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        if name not in _LIBS:
            job = _start(name)
            if job is not None:
                _finish(job)
            _LIBS[name] = ctypes.CDLL(str(_paths(name)[1]))
        return _LIBS[name]
