"""ctypes bindings for the native host-side graph builder (native/*.cpp).

Compiles on demand with g++ into ``native/libbignn_native.so`` (not kept in
git), again whenever ``graphbuild.cpp`` is newer than the library; the C ABI
keeps the binding layer trivial. Every entry point
has a NumPy fallback so the framework works without a toolchain; the native
path is the default when it builds (SURVEY.md §2.2 note on native components).
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import warnings

import numpy as np

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libbignn_native.so"))
_lib = None
_tried = False


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    src = os.path.join(_NATIVE_DIR, "graphbuild.cpp")
    stale = os.path.exists(src) and (
        not os.path.exists(_LIB_PATH)
        or os.path.getmtime(src) > os.path.getmtime(_LIB_PATH))
    if stale:
        # build under a private name and rename: concurrent processes (test
        # workers) never load a half-written library
        tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
        try:
            subprocess.run(
                ["g++", "-O3", "-fPIC", "-shared", "-o", tmp, src],
                check=True, capture_output=True, timeout=120,
            )
            os.replace(tmp, _LIB_PATH)
        except (OSError, subprocess.SubprocessError) as e:
            # no toolchain -> numpy fallback
            warnings.warn(f"native build failed ({e}); using NumPy fallback")
            return None
    if not os.path.exists(_LIB_PATH):
        return None
    try:
        lib = ctypes.CDLL(_LIB_PATH)
    except OSError as e:
        warnings.warn(f"native load failed ({e}); using NumPy fallback")
        return None

    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    lib.build_sorted_graph.restype = ctypes.c_int64
    lib.build_sorted_graph.argtypes = [
        ctypes.c_int64, ctypes.c_int64, i32p, i32p,
        ctypes.c_int32, ctypes.c_int32, i32p, i32p, f32p,
    ]
    lib.in_degrees.restype = None
    lib.in_degrees.argtypes = [ctypes.c_int64, ctypes.c_int64, i32p, i32p]
    lib.partition_edges_hash.restype = None
    lib.partition_edges_hash.argtypes = [
        ctypes.c_int64, i32p, i32p, ctypes.c_int32, i32p,
    ]
    lib.greedy_pack_blocks.restype = ctypes.c_int64
    lib.greedy_pack_blocks.argtypes = [
        ctypes.c_int64, i32p, ctypes.c_int32, i32p,
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def build_sorted_graph(
    src: np.ndarray,
    dst: np.ndarray,
    num_nodes: int,
    add_self_loops: bool = True,
    normalize: bool = True,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Destination-sorted edges (+ self-loops) with GCN weights.

    Native: single-pass counting sort, O(E + N). Fallback: the NumPy path in
    sparse/formats.py. Both produce dst-sorted output; orderings within a
    destination row may differ (sums are order-invariant downstream).
    """
    lib = _load()
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    if lib is None:
        from bignn.sparse import formats as F

        if normalize:
            s, d, w = F.gcn_normalize(src, dst, num_nodes, add_self_loops)
        else:
            if add_self_loops:
                loop = np.arange(num_nodes, dtype=np.int64)
                s = np.concatenate([src, loop])
                d = np.concatenate([dst, loop])
            else:
                s, d = src, dst
            w = np.ones(s.shape[0], np.float32)
        order = np.argsort(d, kind="stable")
        return s[order].astype(np.int32), d[order].astype(np.int32), w[order]

    n_out = len(src) + (num_nodes if add_self_loops else 0)
    out_src = np.empty(n_out, np.int32)
    out_dst = np.empty(n_out, np.int32)
    out_w = np.empty(n_out, np.float32)
    r = lib.build_sorted_graph(
        num_nodes, len(src), src, dst,
        int(add_self_loops), int(normalize), out_src, out_dst, out_w,
    )
    if r < 0:
        raise ValueError("edge endpoints out of range")
    return out_src, out_dst, out_w


def in_degrees(dst: np.ndarray, num_nodes: int) -> np.ndarray:
    lib = _load()
    dst = np.ascontiguousarray(dst, np.int32)
    if lib is None:
        return np.bincount(dst, minlength=num_nodes).astype(np.int32)
    out = np.empty(num_nodes, np.int32)
    lib.in_degrees(num_nodes, len(dst), dst, out)
    return out


def partition_edges_hash(
    src: np.ndarray, dst: np.ndarray, n_parts: int
) -> np.ndarray:
    """Shard id per edge from a hash of the smaller endpoint (P2 partitioner;
    keeps the two directions of an undirected edge on the same shard)."""
    lib = _load()
    src = np.ascontiguousarray(src, np.int32)
    dst = np.ascontiguousarray(dst, np.int32)
    if lib is None:
        key = np.minimum(src, dst).astype(np.uint32)
        key ^= key >> np.uint32(16); key *= np.uint32(0x85EBCA6B)
        key ^= key >> np.uint32(13); key *= np.uint32(0xC2B2AE35)
        key ^= key >> np.uint32(16)
        return (key % np.uint32(n_parts)).astype(np.int32)
    out = np.empty(len(src), np.int32)
    lib.partition_edges_hash(len(src), src, dst, n_parts, out)
    return out


def greedy_pack_blocks(
    sizes: np.ndarray, block_rows: int = 128
) -> tuple[np.ndarray, int]:
    """Greedy first-fit packing of items into fixed block_rows-row blocks
    (no item straddles a boundary). Returns (off [n] int32, extent rows).

    Native: single O(n) pass. Fallback (no toolchain): FIXED-stride packing —
    floor(block_rows / max_size) items per block — which satisfies the same
    layout contract with a larger extent, so callers need no special-casing.
    """
    sizes = np.ascontiguousarray(sizes, np.int32)
    n = len(sizes)
    lib = _load()
    if lib is not None:
        off = np.empty(n, np.int32)
        extent = int(lib.greedy_pack_blocks(n, sizes, block_rows, off))
        if extent >= 0:
            return off, extent
    mx = int(sizes.max()) if n else 1
    if mx > block_rows:
        raise ValueError(f"item size {mx} > block_rows {block_rows}")
    per = max(block_rows // max(mx, 1), 1)
    blk, lane = np.arange(n) // per, np.arange(n) % per
    nb = int(blk[-1]) + 1 if n else 0
    within = np.zeros((nb, per), np.int64)
    within[blk, lane] = sizes
    within = np.cumsum(within, axis=1) - within
    off = (blk * block_rows + within[blk, lane]).astype(np.int32)
    extent = int(off[-1] + sizes[-1]) if n else 0
    return off, extent
