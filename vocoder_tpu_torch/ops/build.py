"""Build and load the hand-written CUDA kernels (``vocoder_tpu_torch/csrc``).

At first use every ``csrc/*.cu`` is compiled by its own ``nvcc`` process,
all started together, into a shared library with a plain C interface under
``build/kernels/`` at the repository root, named by a hash of the sources
and flags so an edit rebuilds, under a file lock so that processes starting
together build each library once.  ``compile_libraries`` is that builder; the
host audio library (``data/native.py``) is built by it too.  The libraries
are loaded with ``ctypes``;
pointers and the stream pass as ``c_void_p``.  Every C entry returns
``cudaGetLastError()`` after its launch, and its wrapper raises when that is
not 0.  PyTorch's headers are kept out of the sources: with them one file takes
minutes to compile, without them seconds.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from collections.abc import Callable
from pathlib import Path
from typing import NamedTuple

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").is_file():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit (nvcc on PATH or CUDA_HOME)")


class Library(NamedTuple):
    """One shared library, built as ``<compiler> *flags -o <target> source *link``."""

    stem: str
    flags: tuple[str, ...]
    source: Path
    link: tuple[str, ...] = ()
    headers: tuple[Path, ...] = ()  # hashed into the name with the source
    host: str = ""  # what else the binary depends on, hashed too (the compiler and CPU, for -march=native)

    def target(self) -> Path:
        h = hashlib.sha256(" ".join((*self.flags, *self.link, self.host)).encode())
        for src in (self.source, *self.headers):
            h.update(src.name.encode())
            h.update(src.read_bytes())
        return BUILD_DIR / f"{self.stem}-{h.hexdigest()[:16]}.so"


def compile_libraries(libs: list[Library], compiler: Callable[[], str]) -> dict[str, Path]:
    """Compile every missing library, one ``compiler()`` process each, all started together; stem -> path.

    The compiler is looked up only when a library is missing.  Raises RuntimeError with the compilers'
    logs when any of them fails."""
    targets = {lib.stem: lib.target() for lib in libs}
    if all(t.is_file() for t in targets.values()):
        return targets
    cc = compiler()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    failed = []
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        procs = {}
        for lib in libs:
            if targets[lib.stem].is_file():  # built by a process that held the lock first
                continue
            tmp = targets[lib.stem].with_suffix(f".{os.getpid()}.tmp")
            cmd = [cc, *lib.flags, "-o", str(tmp), str(lib.source), *lib.link]
            procs[lib.stem] = (lib, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                                          text=True))
        for stem, (lib, tmp, proc) in procs.items():
            log, _ = proc.communicate()
            (BUILD_DIR / f"{stem}.log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"{lib.source.name} ({Path(cc).name} exit {proc.returncode}):\n{log}")
                tmp.unlink(missing_ok=True)
            else:
                os.replace(tmp, targets[stem])
    if failed:
        raise RuntimeError("build failed:\n" + "\n".join(failed))
    return targets


def build_all() -> dict[str, Path]:
    """Compile every missing kernel library in parallel; name -> path."""
    headers = tuple(sorted(CSRC.glob("*.cuh")))
    libs = [Library(p.stem, NVCC_FLAGS, p, headers=headers) for p in sorted(CSRC.glob("*.cu"))]
    return compile_libraries(libs, _nvcc)


def load(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``csrc/<name>.cu``, built at first use."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build_all()[name]))
        return _libs[name]


DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_code(t: torch.Tensor, what: str) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"{what}: dtype {t.dtype} not supported (float32 or bfloat16)")
    return DTYPE_CODES[t.dtype]


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def lengths_arg(lengths, x: torch.Tensor) -> torch.Tensor | None:
    """Per-item lengths as the kernels take them: a contiguous int32 (B,) tensor on x's device, or None.

    The values are not read back to the host: the kernels clamp each to [0, T]."""
    if lengths is None:
        return None
    lengths = torch.as_tensor(lengths)
    if lengths.shape != (x.shape[0],) or lengths.is_floating_point() or lengths.is_complex():
        raise ValueError(f"lengths: expected {x.shape[0]} integer lengths, got {lengths.dtype} {tuple(lengths.shape)}")
    return lengths.to(device=x.device, dtype=torch.int32).contiguous()


def ptr(t: torch.Tensor | None) -> int | None:
    """A tensor's device address for ctypes, None (a null pointer) for None."""
    return None if t is None else t.data_ptr()
