"""Build and load the port's CUDA kernels.

Each library is one or more ``csrc/*.cu`` files with a plain C entry
point, compiled by ``nvcc`` for ``sm_90a`` into ``_build/`` at first use
and loaded with ``ctypes``. The file name carries a hash of the sources and
flags, so an edited source is rebuilt and a built one is reused.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# library name -> its sources under csrc/
LIBRARIES = {
    "gridgen_values": ("gridgen_values.cu",),
    "gridgen_derivs": ("gridgen_derivs.cu",),
    "graph_while": ("graph_while.cu",),
    "packed_eval": ("packed_eval.cu",),
    "ligand_forces": ("ligand_forces.cu",),
    "constraints": ("constraints.cu",),
}

# flags a library adds to NVCC_FLAGS: the constraint solver repeats its
# plain twin's arithmetic, so no product may be fused into an addition
EXTRA_FLAGS = {
    "constraints": ("-fmad=false",),
}


def nvcc_path() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def flags(name: str) -> tuple:
    """nvcc's flags for the library ``name``."""
    return NVCC_FLAGS + EXTRA_FLAGS.get(name, ())


def library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(flags(name)).encode())
    for src in LIBRARIES[name]:
        h.update((CSRC / src).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_log(name: str) -> str:
    """nvcc's output (ptxas registers and spills) from the last build."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def kernel_registers(name: str) -> dict:
    """Registers per thread of each kernel of the library, from the last
    build's ptxas output: {mangled entry function: registers}."""
    out, entry = {}, None
    for line in build_log(name).splitlines():
        found = re.search(r"Compiling entry function '([^']+)'", line)
        if found:
            entry = found.group(1)
        found = re.search(r"Used (\d+) registers", line)
        if found and entry is not None:
            out[entry] = int(found.group(1))
            entry = None
    return out


def sass(name: str) -> str | None:
    """The built library's machine code as ``cuobjdump -sass`` prints it,
    or None where the toolkit has no cuobjdump beside nvcc."""
    tool = Path(nvcc_path()).with_name("cuobjdump")
    if not tool.exists():
        return None
    return subprocess.run([str(tool), "-sass", str(library_path(name))],
                          capture_output=True, text=True, timeout=300,
                          check=True).stdout


def build(names=None) -> dict:
    """Compile the named libraries (all by default) that are not built
    yet: one nvcc per library, all started together. Returns the seconds
    each build took; raises if any build fails."""
    names = list(LIBRARIES) if names is None else list(names)
    BUILD_DIR.mkdir(exist_ok=True)
    jobs = {}
    t0 = time.perf_counter()
    try:
        for name in names:
            so = library_path(name)
            if so.exists():
                continue
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            with open(so.with_suffix(".log"), "w") as log:
                cmd = [nvcc_path(), *flags(name), "-o", str(tmp),
                       *(str(CSRC / s) for s in LIBRARIES[name])]
                proc = subprocess.Popen(cmd, stdout=log,
                                        stderr=subprocess.STDOUT)
            jobs[name] = (proc, tmp, so)
        seconds, failed = {}, []
        for name, (proc, tmp, so) in jobs.items():
            rc = proc.wait()
            seconds[name] = time.perf_counter() - t0
            if rc:
                failed.append(f"{name} (nvcc exit {rc}):\n{build_log(name)}")
            else:
                os.replace(tmp, so)
    finally:
        for proc, _, _ in jobs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return seconds


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library ``name``, building it first if needed."""
    build([name])
    return ctypes.CDLL(str(library_path(name)))
