"""Build the port's CUDA kernels with nvcc and load them through ctypes.

Every ``kernels/*/csrc/<name>.cu`` source has a plain C interface (no
PyTorch headers), so it compiles in seconds into
``build/repro_torch/lib<name>.so`` at the repository root:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/repro_torch/lib<name>.so <name>.cu

``library(name)`` builds a source at first use (again whenever the source
is newer than its library) and loads it; ``build_all`` compiles every
source at once, one nvcc process per source.  Both raise when nvcc is
missing or a build fails; nothing here runs when the module is imported.

``python -m repro_torch.kernels.build [name ...]`` (with ``src`` on the
path, on a machine with nvcc) prints ptxas's report of each kernel of the
named sources: registers, shared memory, spills.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

KERNELS_DIR = Path(__file__).resolve().parent
BUILD_DIR = KERNELS_DIR.parents[2] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")


def sources() -> dict[str, Path]:
    """``{name: path}`` of every CUDA source of the port."""
    return {p.stem: p for p in sorted(KERNELS_DIR.glob("*/csrc/*.cu"))}


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch need "
                       "the CUDA toolkit (set CUDA_HOME or put nvcc on PATH)")


def library_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def build_all(names=None) -> dict[str, tuple[float, str]]:
    """Compile the named sources (default: all) concurrently.

    Returns ``{name: (seconds, compiler output)}``; raises RuntimeError
    with the compiler's output if any build fails.
    """
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = {}
    for name in names:
        tmp = library_path(name).with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp),
               str(srcs[name])]
        procs[name] = (tmp, time.perf_counter(),
                       subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True))
    out, failed = {}, []
    for name, (tmp, t0, proc) in procs.items():
        log, _ = proc.communicate()
        out[name] = (time.perf_counter() - t0, log)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            # atomic: a concurrent reader never loads a half-written file
            os.replace(tmp, library_path(name))
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return out


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built first if it is stale."""
    src = sources()[name]
    path = library_path(name)
    if not path.exists() or path.stat().st_mtime < src.stat().st_mtime:
        build_all([name])
    return ctypes.CDLL(str(path))


def ptxas_report(names=None) -> str:
    """nvcc's ``-Xptxas -v`` output for the named sources (default: all),
    compiled with the build's flags into a file that is then removed."""
    srcs = sources()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = []
    for name in names or srcs:
        tmp = BUILD_DIR / f"ptxas-{name}.{os.getpid()}.so"
        try:
            res = subprocess.run([nvcc(), *NVCC_FLAGS, "-Xptxas", "-v",
                                  "-o", str(tmp), str(srcs[name])],
                                 capture_output=True, text=True)
        finally:
            tmp.unlink(missing_ok=True)
        if res.returncode != 0:
            raise RuntimeError(f"{name}: nvcc exited {res.returncode}\n"
                               f"{res.stdout}{res.stderr}")
        out.append(f"{name}:\n{res.stdout}{res.stderr}")
    return "\n".join(out)


if __name__ == "__main__":
    print(ptxas_report(sys.argv[1:]))
