"""Native C++ engine: the host-side lattice of the service's small-N route.

Port of ``oscillink_tpu/native``: builds its own byte-identical copy of
``engine.cpp`` at first use (g++, cached in the kernels' build directory
under a hash of source and flags) and binds it with ctypes.  Small
requests skip the card's fixed per-request cost; the card keeps large N.
"""

from .engine import NativeBuildError, NativeEngine, load_engine, native_available  # noqa: F401
