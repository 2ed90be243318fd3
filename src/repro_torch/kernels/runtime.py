"""Device resolution and build-at-first-use of the CUDA kernels.

Counterpart of ``repro.kernels.runtime``.  The JAX package resolved an
``interpret`` flag per call; the port has no such switch.  A kernel wrapper
dispatches on the device of the tensors it is given: CPU tensors take the
plain PyTorch version, CUDA tensors launch the hand-written kernel or raise.

Entry points take ``device="cuda"`` by default and resolve it here, so a
machine without a card raises instead of carrying on on the CPU.

The CUDA sources under ``csrc/`` are compiled with ``nvcc`` for ``sm_90a``
the first time a kernel is launched, one ``nvcc`` per source, all started
together, each into its own shared library under ``build/repro_torch/`` at
the root of the checkout.  The build directory is named by a hash of the
sources and flags, so an edited source builds anew and an unchanged one is
loaded as it is.  Nothing is compiled at import time.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}

# the kernels whose plain versions run now, innermost last, while an audit
# observes (:func:`observe`): ``repro_torch.analysis`` tells the plain
# versions' operators from the port's own code by it
regions: list[str] = []
_observers: list = []
_NO_REGION = contextlib.nullcontext()


class _Region:
    """The region of one plain-version call, named for its kernel."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        regions.append(self.name)
        for obs in tuple(_observers):
            obs.enter_region(self.name)

    def __exit__(self, *exc) -> None:
        for obs in tuple(_observers):
            obs.exit_region(self.name)
        regions.pop()


def plain_region(name: str):
    """The context a kernel wrapper runs its plain version in, on CPU
    tensors: one shared no-op context unless an audit observes, then a
    region named ``name`` that the observers are told of."""
    return _Region(name) if _observers else _NO_REGION


@contextlib.contextmanager
def observe(observer):
    """Tell ``observer`` (``enter_region(name)``, ``exit_region(name)``)
    of every plain-version region entered inside the ``with``."""
    _observers.append(observer)
    try:
        yield observer
    finally:
        _observers.remove(observer)


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """``"cuda"`` (the default of every entry point) or ``"cpu"``; raises
    ``RuntimeError`` when a CUDA device is asked for and none is present.

    On a CUDA device it also turns TF32 off for matrix products and cuDNN
    (``torch.backends.cuda.matmul.allow_tf32`` and
    ``torch.backends.cudnn.allow_tf32``), so float32 stays float32 and the
    card agrees with the CPU and the JAX package to float32 rounding."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' was asked for but no CUDA device is available;"
                " pass device='cpu' to run the plain PyTorch versions")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return dev
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build "
                       f"the kernels in {CSRC_DIR}")


def _digest(files: list[Path]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in files:
        h.update(f.name.encode())
        h.update(f.read_bytes())
    return h.hexdigest()[:16]


def build_dir() -> Path:
    """Directory of the libraries built from the current sources."""
    return BUILD_ROOT / _digest(sorted(CSRC_DIR.glob("*.cu")))


def build() -> dict[str, Path]:
    """Compile each ``csrc/<name>.cu`` into ``lib<name>.so`` (unless already
    built from the same sources), one ``nvcc`` per source, all started
    together.  Returns ``{name: library path}``.  Raises with the
    compiler's output when ``nvcc`` is missing or fails."""
    out_dir = build_dir()
    libs = {src.stem: out_dir / f"lib{src.stem}.so"
            for src in sorted(CSRC_DIR.glob("*.cu"))}
    if all(lib.exists() for lib in libs.values()):
        return libs
    nvcc = _nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for name, lib in libs.items():
        # a private name, moved into place whole: a concurrent build of the
        # same sources never loads a half-written library
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs.append((lib, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    log, failed = [], []
    for lib, tmp, cmd, proc in procs:
        text, _ = proc.communicate()
        log.append(" ".join(cmd) + "\n" + text)
        if proc.returncode == 0:
            os.replace(tmp, lib)
        else:
            failed.append(log[-1])
    (out_dir / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError("building the CUDA kernels failed:\n"
                           + "\n".join(failed))
    return libs


def build_log() -> str:
    """The compiler's output of the last build of the current sources
    (``-Xptxas -v``: registers, shared memory and spills per kernel)."""
    path = build_dir() / "build.log"
    return path.read_text() if path.exists() else ""


def load_library(name: str) -> ctypes.CDLL:
    """The shared library of ``csrc/<name>.cu``, built at first use and
    loaded once per process."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(str(build()[name]))
        return _libs[name]


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err:
        cudart = torch.cuda.cudart()
        text = cudart.cudaGetErrorString(cudart.cudaError(err))
        raise RuntimeError(f"{what} failed: CUDA error {err} ({text})")
