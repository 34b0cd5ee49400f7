"""Build and load the port's hand-written CUDA kernels, and count their
launches.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into ``build/lib<name>-<hash>.so`` at first use,
then loaded with ctypes. The hash covers the source, the shared headers
(``csrc/*.cuh``) and the flags, so an edited source rebuilds and an
unchanged one is reused. Nothing here runs at import time: the CPU tests
import every module without a toolkit.

Every kernel wrapper counts its launches in a ``launches`` attribute
through :func:`count_launch`. While a thread captures a CUDA graph
(:func:`recording_launches`) nothing launches: the wrappers' counts go to
the capture's tally instead, and every replay of the graph adds that tally
(:func:`add_launches`). The launches of a capture's warm-up, which steps a
scratch copy of the state and no real one (:func:`warming_up`), go to the
wrapper's ``warmups`` instead of its ``launches``.

The kernels' scratch and barrier words (:func:`device_words`) are one set
per device and key, made zeroed outside any capture and then left to the
kernels: launches that share them run one after another on the device's
current stream, a graph replay included.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from contextlib import contextmanager
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "build"
SOURCES = ("hll_update", "ring_append", "link_chase")
NVCC_FLAGS = (
    "-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# nvcc runs of each source in this process (the device observatory's
# ``compiles`` of the kernel's row)
BUILDS: Dict[str, int] = {}
# compiler output of each source built by this process (``-Xptxas=-v``:
# registers, shared memory and spills of every kernel)
BUILD_LOGS: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return str(path)


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every stale source, one ``nvcc`` per source, all started
    together; returns the library path of each. Raises with the
    compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out, procs = {}, []
    for name in names:
        so = _target(name)
        out[name] = so
        if so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        BUILDS[name] = BUILDS.get(name, 0) + 1
        procs.append((name, so, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, so, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOGS[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, built if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build([name])[name]))
            _libs[name] = lib
        return lib


# -- per-device words ---------------------------------------------------------

_words: Dict[tuple, object] = {}
_words_lock = threading.Lock()


def device_words(key, device, words: int):
    """The int32 ``[words]`` scratch and barrier words of ``key`` (a
    kernel's name and whatever shapes its layout depends on) on
    ``device``, made zeroed at the first call. A capture cannot make them:
    they must outlive the graph's pool, and a memset of them must not be
    part of a replay."""
    import torch

    device = torch.device(device)
    with _words_lock:
        t = _words.get((key, device, words))
        if t is None:
            if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(f"{key}: its device words must be made before a CUDA graph "
                                   "capture (run the kernel once eagerly first)")
            t = _words[(key, device, words)] = torch.zeros(words, dtype=torch.int32, device=device)
        return t


# -- launch counts ----------------------------------------------------------

_capture = threading.local()


def count_launch(wrapper) -> None:
    """One launch of ``wrapper``'s kernel: ``wrapper.launches += 1``;
    inside :func:`recording_launches` on this thread, one more in the
    capture's tally; inside :func:`warming_up`, ``wrapper.warmups += 1``."""
    tally = getattr(_capture, "tally", None)
    if tally is not None:
        tally[wrapper] = tally.get(wrapper, 0) + 1
    elif getattr(_capture, "warming", False):
        wrapper.warmups = getattr(wrapper, "warmups", 0) + 1
    else:
        wrapper.launches += 1


@contextmanager
def warming_up():
    """This thread's launches step a scratch copy of a state before a
    capture (no real state): they count in each wrapper's ``warmups``."""
    _capture.warming = True
    try:
        yield
    finally:
        _capture.warming = False


@contextmanager
def recording_launches():
    """Collect the launches that this thread's wrappers count while a CUDA
    graph is captured: yields the tally ``{wrapper: launches}`` the graph
    holds."""
    if getattr(_capture, "tally", None) is not None:
        raise RuntimeError("a capture is already recording launches on this thread")
    _capture.tally = tally = {}
    try:
        yield tally
    finally:
        _capture.tally = None


def add_launches(tally) -> None:
    """A replay of a graph whose capture recorded ``tally``."""
    for wrapper, n in tally.items():
        wrapper.launches += n
