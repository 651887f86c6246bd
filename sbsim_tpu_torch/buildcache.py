"""The build cache of the port's compiled libraries (the CUDA kernels of
physics/fdm_cuda.py and rng.py, and the host C++ ops of native/).

A library is built from one source at its first use into the package's
_build/ directory, under a name keyed by the digest of the source, the
compiler's name and its flags, so an edited source or changed flags build
anew and an unchanged one is loaded as it is.

The build is atomic: the compiler writes a file of its own (named by the
process and a random suffix) in the build directory, which `os.replace`
moves into place, so processes that build at once each load a whole
library. A failed build raises RuntimeError with the compiler's output.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import uuid
from typing import Callable, Optional, Sequence, Tuple

BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "_build")


def nvcc() -> str:
    """The CUDA compiler: `nvcc` on the PATH, else the toolkit's default
    place. Raises RuntimeError if neither is there."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def library_path(source: str, stem: str, compiler: str, flags: Sequence[str],
                 build_dir: str = BUILD_DIR) -> str:
    """Where the library of `source` is built: `build_dir`/<stem>_<digest>.so."""
    with open(source, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join((compiler, *flags)).encode())
    return os.path.join(build_dir, f"{stem}_{digest.hexdigest()[:16]}.so")


def build(source: str, stem: str, compiler: str, flags: Sequence[str],
          build_dir: str = BUILD_DIR,
          executable: Optional[Callable[[], str]] = None) -> Tuple[str, Optional[str]]:
    """Compiles `source` with `compiler` and `flags` unless its library is
    built already. Returns the library's path and the compiler's output
    (None where it was built before). `executable` resolves the compiler's
    program where it is not found by its name; it is called only to build.
    Raises RuntimeError if the compiler cannot be run or fails."""
    path = library_path(source, stem, compiler, flags, build_dir)
    if os.path.exists(path):
        return path, None
    program = executable() if executable is not None else compiler
    os.makedirs(build_dir, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.{uuid.uuid4().hex}.tmp"
    try:
        proc = subprocess.run([program, *flags, source, "-o", tmp],
                              capture_output=True, text=True)
    except OSError as err:
        raise RuntimeError(f"{compiler} could not be run to build {source}: {err}") from err
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"{compiler} failed on {source}:\n{log}")
    os.replace(tmp, path)
    return path, log
