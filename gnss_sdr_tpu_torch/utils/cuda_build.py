"""Build and load the hand-written CUDA kernels of ``gnss_sdr_tpu_torch/csrc``.

Each ``csrc/<name>.cu`` exports plain C entry points and is compiled by
``nvcc`` into ``build/kernels/<name>-<hash>.so`` at the repository root, keyed
on the source's content, every shared header ``csrc/*.cuh`` and the compiler
flags, so a fresh checkout builds on first use and an edited source, header
or flag rebuilds. The library is then loaded with
``ctypes`` (no PyTorch headers are compiled, which keeps a build to seconds).

Nothing here runs at import time: the CPU-only test environment imports every
module of the port and has no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "build only on a machine with the CUDA toolkit")
    return found


def library_path(name: str) -> pathlib.Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_many(names) -> dict:
    """Compile ``csrc/<name>.cu`` for every name not built already, one
    ``nvcc`` per source, all started together. Returns {name: {"path",
    "seconds", "report"}} where ``report`` is nvcc's output (the ``-Xptxas
    -v`` register / shared-memory / spill lines); raises if a build
    fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs, results = {}, {}
    for name in names:
        out = library_path(name)
        if out.exists():
            results[name] = dict(path=out, seconds=0.0, report="(cached)")
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        procs[name] = (out, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (out, tmp, proc) in procs.items():
        report, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{report}")
            continue
        os.replace(tmp, out)
        results[name] = dict(path=out, seconds=time.perf_counter() - t0,
                             report=report)
    if failed:
        raise RuntimeError("kernel build failed: " + "\n".join(failed))
    return results


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_many([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib
