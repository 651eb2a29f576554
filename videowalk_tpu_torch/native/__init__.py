"""The port's host C++ (counterpart of the JAX package's ``native/``): the
SLIC and Felzenszwalb segmenters of ``superpixels.cc``, built with g++ at
first use and loaded with ``ctypes``:

    g++ -O3 -shared -fPIC -std=c++17 superpixels.cc -o _build/lib<name>-<hash>.so

The hash is of the source and the flags (as ``ops/_build.py`` names the CUDA
libraries), so an edited source never loads a stale library. ``_build/`` is
listed in ``.gitignore``. A failed build raises with the command and g++'s
output; nothing falls back to another segmenter on its own.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(_HERE, "_build")
CXX = "g++"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _target(name: str) -> tuple[str, list[str]]:
    src = os.path.join(_HERE, f"{name}.cc")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(CXX_FLAGS).encode())
    lib = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")
    return lib, [CXX, *CXX_FLAGS, src]


def build(name: str) -> str:
    """Compile ``<name>.cc`` unless its up-to-date library exists; returns
    the library's path. Raises ``RuntimeError`` naming the command and
    g++'s output when the compiler fails or cannot be started."""
    lib, cmd = _target(name)
    if os.path.isfile(lib):
        return lib
    os.makedirs(BUILD_DIR, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = cmd + ["-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        raise RuntimeError(f"host C++ build failed: {' '.join(cmd)}: {e}"
                           ) from e
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"host C++ build failed (exit {proc.returncode}): "
            f"{' '.join(cmd)}\n{proc.stderr}{proc.stdout}")
    os.replace(tmp, lib)
    return lib


def build_and_load(name: str) -> ctypes.CDLL:
    """The loaded library of ``<name>.cc``, built if needed."""
    with _lock:
        if name not in _libs:
            _libs[name] = ctypes.CDLL(build(name))
        return _libs[name]
