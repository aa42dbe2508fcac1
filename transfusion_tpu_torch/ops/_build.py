"""Build and load the port's native code: the CUDA kernels and the host
batch packer.

Each `csrc/<name>.cu` is compiled on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/transfusion_tpu_torch/<name>-<hash>.so

and each host source `csrc/<name>.cpp` (HOST_SOURCES) with

    c++ -O3 -std=c++17 -shared -fPIC -o build/transfusion_tpu_torch/<name>-<hash>.so

into `build/transfusion_tpu_torch/` at the repository root (listed in
`.gitignore`) and loaded with `ctypes`. The sources expose a plain C
interface, so no PyTorch or Python header is compiled and a build takes
seconds. The file name carries a hash of the sources, so an edited source
is rebuilt. A build writes a name of its own (the process id in it) and
renames it into place, so processes that build at once each load a whole
library. The compiler's output (for a kernel, `ptxas -v`: registers,
shared memory, spills) is kept beside each library as `<name>-<hash>.log`.

Nothing here runs at import time: `load(name, argtypes)` builds on first use, and
`build_all()` starts one compiler per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "transfusion_tpu_torch"
SOURCES = ("flash_fwd", "flash_bwd", "decode_attn")
HOST_SOURCES = ("fastpack",)
CXX = "c++"  # the host compiler

_lock = threading.Lock()
_libs: dict[str, ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if os.path.exists(fallback):
        return fallback
    raise RuntimeError(
        "nvcc not found: the port's CUDA kernels are built from source at "
        "first use and need the CUDA toolkit on PATH or under $CUDA_HOME"
    )


def _sources(name: str) -> list[Path]:
    """The files a build of `name` reads: a host source alone, a kernel's
    `.cu` with every `.cuh`."""
    if name in HOST_SOURCES:
        return [CSRC / f"{name}.cpp"]
    return [src for src in sorted(CSRC.glob("*.cu*")) if src.suffix == ".cuh" or src.stem == name]


def _paths(name: str) -> tuple[Path, Path]:
    digest = hashlib.sha256()
    for src in _sources(name):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    tag = digest.hexdigest()[:12]
    return BUILD_DIR / f"{name}-{tag}.so", BUILD_DIR / f"{name}-{tag}.log"


def _command(name: str, out: Path) -> list[str]:
    if name in HOST_SOURCES:
        return [CXX, "-O3", "-std=c++17", "-shared", "-fPIC", "-o", str(out),
                str(CSRC / f"{name}.cpp")]
    return [
        nvcc_path(),
        "-gencode", "arch=compute_90a,code=sm_90a",
        "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-Xptxas", "-v",
        "-o", str(out), str(CSRC / f"{name}.cu"),
    ]


def build_all(names=SOURCES) -> dict[str, Path]:
    """Compile every missing library, one compiler process per source, all
    started together. Raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs, errors = {}, []
    for name in names:
        so, log = _paths(name)
        if so.exists():
            continue
        tmp = so.with_suffix(f".tmp{os.getpid()}.so")
        command = _command(name, tmp)
        try:
            proc = subprocess.Popen(command, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)
        except OSError as e:
            errors.append(f"{command[0]} for {name} did not start: {e}")
            continue
        procs[name] = (proc, command, tmp, so, log)
    for name, (proc, command, tmp, so, log) in procs.items():
        output, _ = proc.communicate()
        log.write_text(output)
        if proc.returncode != 0:
            errors.append(f"{command[0]} {Path(command[-1]).name} failed ({proc.returncode}):\n"
                          f"{output}")
        else:
            os.replace(tmp, so)
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: _paths(name)[0] for name in names}


def load(name: str, argtypes) -> ctypes._CFuncPtr:
    """The C function `name` of `csrc/<name>.cu` or `.cpp` (built on first
    use), with its argument types declared and an int result (a kernel's
    cudaError_t)."""
    with _lock:
        fn = _libs.get(name)
        if fn is None:
            so = build_all((name,))[name]
            fn = getattr(ctypes.CDLL(str(so)), name)
            fn.restype = ctypes.c_int
            fn.argtypes = list(argtypes)
            _libs[name] = fn
        return fn


def ptxas_log(name: str) -> str:
    """ptxas resource report of the current build of `name` ('' if unbuilt)."""
    log = _paths(name)[1]
    return log.read_text() if log.exists() else ""


def check(err: int, what: str):
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
