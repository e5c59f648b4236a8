"""ctypes bindings for the native (C++) host-runtime components.

The reference is a C++ library end to end; here the device compute path
is JAX/XLA, and the host runtime pieces that remain genuinely
host-side — topology compilation (the graph-builder step, reference:
lqr.cpp:563-631) — are implemented natively here and consumed via ctypes.
The shared library is built on demand with g++ and cached next to the
source; every entry point has a NumPy fallback with identical semantics
(types.compile_topology), and the tests assert agreement.

Set SOC_DISABLE_NATIVE=1 to force the NumPy path (e.g. no compiler in the
deployment image).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).parent / "topology.cpp"
_LIB = Path(__file__).parent / "libsoc_topology.so"
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False

_STATUS_MESSAGES = {
    1: "root out of range",
    2: "edge endpoints out of range or self-loop",
    3: "node has in-degree > 1 (or root has an incoming edge)",
    4: "cycle detected",
    5: "tree is disconnected",
}


def _build() -> bool:
    # build to a private name and rename: several processes (test workers)
    # may build at once, and none may load a half-written library
    tmp = _LIB.with_name(f"{_LIB.name}.{os.getpid()}.tmp")
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17",
             "-o", str(tmp), str(_SRC)],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, _LIB)
        return True
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False


def load() -> Optional[ctypes.CDLL]:
    """Load (building if needed) the native library; None if unavailable."""
    global _lib, _tried
    if _lib is not None:
        return _lib
    if os.environ.get("SOC_DISABLE_NATIVE"):
        return None
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not _LIB.exists() or _LIB.stat().st_mtime < _SRC.stat().st_mtime:
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(str(_LIB))
        except OSError:
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        lib.soc_compile_topology.restype = ctypes.c_int32
        lib.soc_compile_topology.argtypes = [
            ctypes.c_int32, ctypes.c_int32, i32p, i32p,
            i32p, i32p, i32p, i32p, i32p, i32p]
        lib.soc_topology_abi_version.restype = ctypes.c_int32
        if lib.soc_topology_abi_version() != 1:
            return None
        _lib = lib
    return _lib


def compile_topology_native(num_edges: int, root: int,
                            edge_parents, edge_children
                            ) -> Optional[Tuple[np.ndarray, ...]]:
    """Run the native graph builder.

    Returns (child_offsets, child_edges, preorder, depth, parent_edge,
    parent_node) or None when the native library is unavailable.  Raises
    ValueError (with the same conditions as the NumPy path) on invalid
    topologies.
    """
    lib = load()
    if lib is None:
        return None
    num_nodes = num_edges + 1
    parents = np.ascontiguousarray(edge_parents, dtype=np.int32)
    children = np.ascontiguousarray(edge_children, dtype=np.int32)
    child_offsets = np.zeros(num_nodes + 1, dtype=np.int32)
    child_edges = np.zeros(max(num_edges, 1), dtype=np.int32)[:num_edges]
    preorder = np.zeros(num_nodes, dtype=np.int32)
    depth = np.zeros(num_nodes, dtype=np.int32)
    parent_edge = np.zeros(num_nodes, dtype=np.int32)
    parent_node = np.zeros(num_nodes, dtype=np.int32)

    def ptr(a):
        if a.size == 0:
            return None
        return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))

    status = lib.soc_compile_topology(
        num_edges, root, ptr(parents), ptr(children), ptr(child_offsets),
        ptr(child_edges), ptr(preorder), ptr(depth), ptr(parent_edge),
        ptr(parent_node))
    if status != 0:
        raise ValueError(_STATUS_MESSAGES.get(int(status),
                                              f"status {status}"))
    return (child_offsets, child_edges, preorder, depth, parent_edge,
            parent_node)
