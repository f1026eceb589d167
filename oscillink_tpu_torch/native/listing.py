"""The receipt's null-point listing, built in native code from one packed copy.

A full receipt lists every flagged row as
``{"edge": [i, j], "z": z, "residual": r}``; on a corpus lattice that is
nearly every row.  Built by a comprehension, each row costs a list and a
dict that the cyclic collector tracks, and Python 3.12 runs a young
collection every 700 of them while the bytecode loop runs.  Here the rows
leave the device as one ``[n, 4]`` int32 buffer (`pack_null_rows`: i, j and
the bits of the float32 z and r), and ``listing.c`` beside this file builds
the same list of dicts from that buffer through the CPython API, running no
bytecode.

``listing.c`` is compiled at first use with ``$CXX`` (``g++`` by default)
against this interpreter's headers into the kernels' build directory
(`ops.kernels.build.BUILD_DIR`), named by a hash of the source, the flags
and the interpreter's ABI, compiled to a temporary name and renamed into
place, and loaded with `ctypes.PyDLL`.  Where it cannot be built or loaded
(no compiler, no ``Python.h``), `list_null_points` builds the identical list
in Python; a failure is remembered for its library path and compiler.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import sysconfig
import threading
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from ..ops.kernels import build as _kbuild
from .engine import NativeBuildError, _cxx, compile_library

__all__ = ["list_flagged", "list_null_points", "pack_null_rows"]

_SRC = Path(__file__).with_name("listing.c")
_LOCK = threading.Lock()
# loaded builders, or None for a failed build, by (library path, compiler)
_BUILDERS: dict[tuple[str, str], Optional[Callable]] = {}


def _flags() -> list[str]:
    include = sysconfig.get_paths()["include"]
    return ["-O2", "-shared", "-fPIC", f"-I{include}"]


@functools.cache
def _lib_name() -> str:
    abi = sysconfig.get_config_var("SOABI") or ""
    key = hashlib.sha256(_SRC.read_bytes() + "\0".join([*_flags(), abi]).encode())
    return f"osclisting_{key.hexdigest()[:16]}.so"


def _builder() -> Optional[Callable]:
    """``osc_null_listing`` from the library, built unless it exists; None
    where it cannot be built or loaded."""
    lib = Path(_kbuild.BUILD_DIR) / _lib_name()
    key = (str(lib), _cxx())
    with _LOCK:
        if key in _BUILDERS:
            return _BUILDERS[key]
        fn = None
        try:
            fn = ctypes.PyDLL(str(compile_library(_SRC, _flags(), lib))).osc_null_listing
            fn.restype = ctypes.py_object
            fn.argtypes = [ctypes.c_void_p, ctypes.c_ssize_t]
        except NativeBuildError:
            pass
        except OSError:
            lib.unlink(missing_ok=True)  # a corrupt library: the next process rebuilds
        _BUILDERS[key] = fn
        return fn


def pack_null_rows(
    i: torch.Tensor, j: torch.Tensor, z: torch.Tensor, r: torch.Tensor
) -> torch.Tensor:
    """Rows ``(i, j, z, r)`` as one ``[n, 4]`` int32 tensor on their device:
    i and j as int32 (N < 2**31), z and r float32, bit-viewed."""
    return torch.stack(
        (i.to(torch.int32), j.to(torch.int32), z.view(torch.int32), r.view(torch.int32)),
        dim=1,
    )


def _python_listing(a: np.ndarray) -> list[dict]:
    f = a.view(np.float32)
    rows = zip(a[:, 0].tolist(), a[:, 1].tolist(), f[:, 2].tolist(), f[:, 3].tolist())
    return [{"edge": [i, j], "z": z, "residual": r} for i, j, z, r in rows]


def list_null_points(rows: torch.Tensor) -> tuple[list[dict], bool]:
    """The null-point dicts of host rows packed by `pack_null_rows`, in row
    order, and whether the native builder made them."""
    if rows.device.type != "cpu" or rows.dtype != torch.int32 or rows.shape[1:] != (4,):
        raise ValueError(
            f"rows must be a host int32 [n, 4] tensor, got {rows.dtype} "
            f"{tuple(rows.shape)} on {rows.device}"
        )
    a = np.ascontiguousarray(rows.numpy())
    build = _builder()
    if build is None:
        return _python_listing(a), False
    return build(a.ctypes.data, a.shape[0]), True


def list_flagged(flag, j, z, r) -> list[dict]:
    """The null-point dicts of the rows i where host ``flag[i]`` is set, from
    the [N] vectors (numpy arrays or tensors) of their argmax-residual
    neighbour j, z-score and residual (float32), in row order."""
    flag, j, z, r = (torch.as_tensor(a) for a in (flag, j, z, r))
    i = torch.arange(flag.shape[0], dtype=torch.int32)
    return list_null_points(pack_null_rows(i, j, z, r)[flag.bool()])[0]
