"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into ``<name>-<hash>.so`` under `BUILD_DIR`.  The hash is taken over the
source text and the compiler flags, so an edited source rebuilds and an
unchanged one loads the library already built.  Nothing here runs at
import: the CPU tests import every module on machines that have neither
``nvcc`` nor a card.

`BUILD_DIR` is ``build/oscillink_tpu_torch/`` at the checkout root (listed
in ``.gitignore``) when the package runs from a checkout.  An installed
copy has no checkout to write into and builds under the user's cache
directory instead: ``$XDG_CACHE_HOME/oscillink_tpu_torch``, by default
``~/.cache/oscillink_tpu_torch``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC_DIR", "NVCC_FLAGS", "build", "load_library", "nvcc_command"]

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"


def _build_dir(package_dir: Path) -> Path:
    """The checkout's ``build/`` when ``package_dir`` sits in a checkout (its
    parent holds ``pyproject.toml``), else the user's cache directory."""
    root = package_dir.parent
    if (root / "pyproject.toml").exists():
        return root / "build" / "oscillink_tpu_torch"
    cache = os.environ.get("XDG_CACHE_HOME") or str(Path.home() / ".cache")
    return Path(cache) / "oscillink_tpu_torch"


BUILD_DIR = _build_dir(PACKAGE_DIR)

# sm_90a (not sm_90): the 'a' target is what admits Hopper-only instructions
# (wgmma, setmaxnreg) in later kernels; -Xptxas -v records registers and
# spills into the build log beside each library.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (looked on PATH and under $CUDA_HOME/bin)")


def nvcc_command(src: str | Path, out: str | Path) -> list[str]:
    """The ``nvcc`` command line that compiles the CUDA source ``src`` into
    the shared library ``out`` with `NVCC_FLAGS`, as `build` runs it."""
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(src)]


def _target(name: str) -> tuple[Path, Path]:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return src, BUILD_DIR / f"{name}-{digest[:16]}.so"


def build(names: list[str]) -> None:
    """Compile every ``csrc/<name>.cu`` of ``names`` whose library is
    missing, one ``nvcc`` per source, all started together.  Raises with the
    compiler's output of each failed build; ``nvcc``'s output is kept beside
    the library as ``<name>-<hash>.log``."""
    jobs = []
    for name in names:
        src, lib = _target(name)
        if lib.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            nvcc_command(src, tmp),
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        jobs.append((name, lib, tmp, proc))
    failed = []
    for name, lib, tmp, proc in jobs:
        out, _ = proc.communicate()
        lib.with_suffix(".log").write_text(out)
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed for {name}.cu:\n{out}")
        else:
            # atomic publish: a concurrent build of the same hash either sees
            # no library or the whole one
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, compiled first (`build`)
    unless a library of the same hash exists."""
    build([name])
    return ctypes.CDLL(str(_target(name)[1]))
