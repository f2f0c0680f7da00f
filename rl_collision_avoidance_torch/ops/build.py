"""Build the port's CUDA kernels with one plain ``nvcc`` call and load them.

Every ``ops/csrc/*.cu`` source goes into one shared library with a C
interface, loaded with ``ctypes``; ``*.cuh`` headers beside them are shared
between sources.  The library lands in
``rl_collision_avoidance_torch/_build/<hash>/`` (listed in ``.gitignore``),
keyed by a hash of the sources, headers and flags, so a changed source rebuilds and
an unchanged one loads at once.  The finished library is moved into place
with one rename: no lock file, so an interrupted build leaves nothing that
blocks the next one.  Building needs the CUDA toolkit (``nvcc``) and runs
only on first use, never at import.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
LIB_NAME = "librca_kernels.so"
# No --use_fast_math: the geometry needs IEEE division and square roots.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu*")):    # sources and headers
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build() -> Path:
    """Compile every ``csrc/*.cu`` into one ``.so`` (once per source hash) and
    return its path.  Prints the seconds taken and ``-Xptxas -v``'s register,
    shared-memory and spill lines when it compiles."""
    srcs = sources()
    out_dir = BUILD_ROOT / _digest()
    lib = out_dir / LIB_NAME
    if lib.is_file():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"{LIB_NAME}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, srcs)]
    t0 = time.perf_counter()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300, check=True)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"nvcc failed ({e.returncode}):\n{e.stdout}\n"
                           f"{e.stderr}") from e
    seconds = time.perf_counter() - t0
    os.replace(tmp, lib)
    print(f"nvcc: built {lib.name} from {len(srcs)} sources in "
          f"{seconds:.2f} s", flush=True)
    for line in (proc.stdout + proc.stderr).splitlines():
        if any(w in line for w in ("Compiling entry", "registers", "spill",
                                   "smem")):
            print("  " + line.strip(), flush=True)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    return ctypes.CDLL(str(build()))


def check(status: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launcher."""
    if status != 0:
        fn = library().rca_error_string
        fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {status} "
                           f"({fn(status).decode()})")
