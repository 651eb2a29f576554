"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` compiles on its own into ``_build/lib<name>-<hash>.so``
(a plain C interface, loaded with ``ctypes``):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o _build/lib<name>-<hash>.so csrc/<name>.cu

(``-Xptxas -v`` reports each kernel's registers and spills; the report is
kept beside the library as ``lib<name>-<hash>.log``, ``build_log``.)
The hash is of the source and the flags, so an edited source never loads a
stale library. The build happens at first use (``load``), or for every
source at once with one ``nvcc`` each, all started together (``build_all``).
``_build/`` is listed in ``.gitignore``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def nvcc_path() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and os.path.isfile(os.path.join(home, "bin", "nvcc")):
            return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"   # the CUDA toolkit's default prefix
    if os.path.isfile(default):
        return default
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "videowalk_tpu_torch are built at first use")


def sources() -> list[str]:
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _target(name: str) -> tuple[str, list[str]]:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    lib = os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")
    return lib, [nvcc_path(), *NVCC_FLAGS, src]


def build_all(names=None) -> dict[str, str]:
    """Compile every source that has no up-to-date library, one ``nvcc``
    process each, all started together. Returns {name: nvcc output (the
    ptxas register and spill report)} for the sources it compiled."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names or sources():
        lib, cmd = _target(name)
        if os.path.isfile(lib):
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        procs[name] = (lib, tmp, subprocess.Popen(
            cmd + ["-o", tmp], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    failed, logs = [], {}
    for name, (lib, tmp, p) in procs.items():
        out, _ = p.communicate()
        logs[name] = out
        if p.returncode != 0:
            os.unlink(tmp)
            failed.append(f"{name}.cu (nvcc exit {p.returncode}):\n{out}")
        else:
            # the log, then the library, each renamed into place whole:
            # two processes that build the same source (ranks sharing a
            # checkout) each replace the other's copy atomically
            fd, tmp_log = tempfile.mkstemp(suffix=".log", dir=BUILD_DIR)
            with os.fdopen(fd, "w") as fh:
                fh.write(out)
            os.replace(tmp_log, _log_path(lib))
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return logs


def _log_path(lib: str) -> str:
    return lib[:-len(".so")] + ".log"


def build_log(name: str) -> str | None:
    """nvcc's output of the build of ``csrc/<name>.cu``'s up-to-date
    library (also when it was built by an earlier process), or None where
    there is no such library or it was built without its log."""
    lib, _ = _target(name)
    path = _log_path(lib)
    if not (os.path.isfile(lib) and os.path.isfile(path)):
        return None
    with open(path) as fh:
        return fh.read()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built if needed."""
    with _lock:
        if name not in _libs:
            lib, _ = _target(name)
            if not os.path.isfile(lib):
                build_all([name])
            _libs[name] = ctypes.CDLL(lib)
        return _libs[name]
