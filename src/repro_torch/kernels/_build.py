"""Build and load the hand-written CUDA kernels.

Each kernel source under ``csrc/`` exposes a plain C entry point.  It is
compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/repro_torch/`` at the repository root, named by the hash of its
source and of the local headers it includes (``#include "..."``), so an
edited source or header rebuilds, and loaded with ``ctypes``.  Nothing
is compiled when a module is imported: the first launch (or the first
``CudaKernel.fn()`` call) builds.  Without ``nvcc`` the build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Sequence

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
_LOCAL_INCLUDE = re.compile(rb'^\s*#\s*include\s*"([^"]+)"', re.MULTILINE)


def local_sources(source: Path) -> list:
    """``source`` and every header it includes with ``#include "..."``
    (found beside the including file), recursively, each once."""
    seen, todo = [], [source.resolve()]
    while todo:
        path = todo.pop(0)
        if path in seen:
            continue
        seen.append(path)
        for name in _LOCAL_INCLUDE.findall(path.read_bytes()):
            todo.append((path.parent / name.decode()).resolve())
    return seen


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (put the CUDA toolkit's bin/ on PATH "
                       "or set CUDA_HOME); the CUDA kernels cannot be built")


class CudaKernel:
    """One ``csrc/`` source, its C entry point and its launch count.

    The entry point returns the ``cudaError_t`` of its launch as an int;
    ``check`` raises on anything but success.

    ``launches`` is incremented by the kernel's wrapper (``count_launch``)
    exactly where it launches, and nowhere else: a run reads it to show
    which path it took.  A source with several kernels names its ``routes``
    and counts each launch under one of them too (``route_launches``);
    ``launches`` stays the total.  Several prefetch threads may launch one
    kernel at once (device sampling), so the increment takes a lock.
    ``build_log`` keeps what ``nvcc -Xptxas -v`` printed (registers, spills)
    and ``build_s`` the compile time (0 when the library was already built).
    A source may export more C entry points than ``symbol``: ``symbols``
    maps each further name to its argument types, and ``fn(name)`` loads it
    from the same library.
    """

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence, routes: Sequence[str] = (),
                 symbols: dict | None = None):
        self.name = name
        self.source = _PKG / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.symbols = {symbol: self.argtypes,
                        **{k: list(v) for k, v in (symbols or {}).items()}}
        self.launches = 0
        self.route_launches = dict.fromkeys(routes, 0)
        self.build_log = ""
        self.build_s = 0.0
        self._lib = None
        self._fns = {}
        self._lock = threading.Lock()
        self._count_lock = threading.Lock()

    def library_path(self) -> Path:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in local_sources(self.source):
            h.update(path.name.encode() + b"\0" + path.read_bytes())
        return BUILD_DIR / f"{self.source.stem}-{h.hexdigest()[:16]}.so"

    def _build(self) -> None:
        """Compile this source with nvcc unless its library exists."""
        out = self.library_path()
        if out.exists():
            return
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        self.build_log = proc.stdout
        self.build_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {self.source.name} "
                               f"(exit {proc.returncode}):\n{proc.stdout}")
        os.replace(tmp, out)

    def fn(self, symbol: str | None = None):
        """The loaded C entry point ``symbol`` (default: the kernel's own),
        building the library on first use."""
        symbol = self.symbol if symbol is None else symbol
        f = self._fns.get(symbol)
        if f is None:
            with self._lock:
                if self._lib is None:
                    self._build()
                    self._lib = ctypes.CDLL(str(self.library_path()))
                f = self._fns.get(symbol)
                if f is None:
                    f = getattr(self._lib, symbol)
                    f.argtypes = self.symbols[symbol]
                    f.restype = ctypes.c_int  # the launch's cudaError_t
                    self._fns[symbol] = f
        return f

    def count_launch(self, route: str | None = None) -> None:
        with self._count_lock:
            self.launches += 1
            if route is not None:
                self.route_launches[route] += 1

    def reset_launches(self) -> None:
        with self._count_lock:
            self.launches = 0
            self.route_launches = dict.fromkeys(self.route_launches, 0)

    def check(self, err: int) -> None:
        if err != 0:
            raise RuntimeError(f"CUDA kernel {self.name} failed to launch: "
                               f"cudaError {err}")



# peer access between the cards of one clique (csrc/peer_access.cu): no
# kernel, one C entry point, built at its first use
PEER_ACCESS = CudaKernel("peer_access", "csrc/peer_access.cu",
                         "enable_peer_access", [ctypes.c_int, ctypes.c_int])
_PEERS_ENABLED: set = set()
_PEERS_LOCK = threading.Lock()


def enable_peer_access(device: int, peer: int) -> None:
    """Let kernels running on CUDA card ``device`` read card ``peer``'s
    memory through a plain pointer: one ``cudaDeviceEnablePeerAccess`` per
    ordered pair for the life of the process (an access PyTorch enabled
    already counts as enabled).  Raises if the runtime refuses."""
    key = (int(device), int(peer))
    if key[0] == key[1]:
        return
    with _PEERS_LOCK:
        if key in _PEERS_ENABLED:
            return
        err = PEER_ACCESS.fn()(*key)
        if err != 0:
            raise RuntimeError(f"peer access from cuda:{key[0]} to "
                               f"cuda:{key[1]} refused: cudaError {err}")
        _PEERS_ENABLED.add(key)
