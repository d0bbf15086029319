"""Build the CUDA kernels with nvcc and load them through ctypes.

Each ``kernels/<name>/csrc/<name>.cu`` becomes one shared library with a
plain C interface, compiled for Hopper (``sm_90a``) by its own nvcc process.
Libraries land in ``kernels/_build/`` (git-ignored), named by a hash of
their sources and flags, so a changed source rebuilds and an unchanged one
is reused. Every C entry point returns ``cudaGetLastError()`` after its
launches; ``check`` turns a non-zero code into an exception.
"""
from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Optional

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LOADED: Dict[str, ctypes.CDLL] = {}


@dataclasses.dataclass
class Built:
    name: str
    path: Path
    log: str        # nvcc/ptxas output: registers, shared memory, spills


def kernel_names():
    return sorted(p.parent.parent.name for p in KERNELS_DIR.glob("*/csrc/*.cu"))


def _source(name: str) -> Path:
    src = KERNELS_DIR / name / "csrc" / f"{name}.cu"
    if not src.exists():
        raise FileNotFoundError(f"no CUDA source for kernel {name!r}: {src}")
    return src


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in sorted(_source(name).parent.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                           "machine with the CUDA toolkit")
    return str(path)


def build(names: Optional[Iterable[str]] = None) -> Dict[str, Built]:
    """Compile the named kernels (all by default), one nvcc process per
    source, all started together; up-to-date libraries are reused."""
    names = list(kernel_names() if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    try:
        for name in names:
            so = library_path(name)
            if so.exists():
                continue
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(_source(name))]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT,
                                            text=True), tmp, so)
        failed = []
        for name, (proc, tmp, so) in procs.items():
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {name}:\n{out}")
                continue
            so.with_suffix(".log").write_text(out)
            os.replace(tmp, so)
        if failed:
            raise RuntimeError("\n".join(failed))
    finally:
        for proc, _, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out = {}
    for name in names:
        so = library_path(name)
        log = so.with_suffix(".log")
        out[name] = Built(name, so, log.read_text() if log.exists() else "")
    return out


def load(name: str) -> ctypes.CDLL:
    """The kernel's shared library, built at first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name].path))
        _LOADED[name] = lib
    return lib


def check(code: int, what: str, message: bytes = b"") -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} "
                           f"({message.decode(errors='replace')})")
