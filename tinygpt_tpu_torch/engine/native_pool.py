"""The KV-pool index: block allocation plus the prefix-hash map.

Counterpart of tinygpt_tpu/engine/native_pool.py: refcounted blocks, an
idle-cached LRU tier for registered prompt prefixes, and the hash -> block
prefix index, either in the C++ core ``csrc/kvpool.cpp`` (NativePoolIndex,
bound with ctypes, built by ``ops/host_build.py`` at first use) or in pure
Python over BlockAllocator (PythonPoolIndex, the reference and the
fall-back). Allocation order and eviction order are the JAX index's in
both (LIFO free list, oldest-tick eviction), so the two are
interchangeable block for block. ``create_pool_index`` takes the native
index whenever its library builds and loads; ``TINYGPT_NO_NATIVE`` (any
non-empty value) selects the Python one. An index names itself in
``kind`` ("native" or "python").
"""

from __future__ import annotations

import ctypes
import threading
from typing import List, Optional, Sequence

from tinygpt_tpu_torch.engine.paged_kv import BlockAllocator
from tinygpt_tpu_torch.utils.logging import get_logger

log = get_logger("engine.native_pool")

_LOCK = threading.Lock()
_LIB = None
_TRIED = False
_ABI_VERSION = 2
_U64_MASK = (1 << 64) - 1


def _load():
    """The kvpool library with its C signatures declared, or None when it
    cannot be built or loaded (logged once)."""
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        from tinygpt_tpu_torch.ops import host_build

        lib = host_build.load("kvpool.cpp")
        if lib is None:
            return None
        i32p, vp = ctypes.POINTER(ctypes.c_int32), ctypes.c_void_p
        u64, i32 = ctypes.c_uint64, ctypes.c_int32
        sigs = {
            "tg_pool_create": ([i32], vp),
            "tg_pool_destroy": ([vp], None),
            "tg_pool_n_free": ([vp], i32),
            "tg_pool_alloc": ([vp, i32, i32p], i32),
            "tg_pool_share": ([vp, i32p, i32], None),
            "tg_pool_release": ([vp, i32p, ctypes.POINTER(ctypes.c_uint8), i32],
                                None),
            "tg_pool_register_prefix": ([vp, u64, u64, i32], None),
            "tg_pool_lookup_prefix": ([vp, u64, u64], i32),
            "tg_pool_block_is_registered": ([vp, i32], i32),
            "tg_pool_n_idle_cached": ([vp], i32),
            "tg_pool_abi_version": ([], ctypes.c_int),
        }
        for name, (args, res) in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, res
        if lib.tg_pool_abi_version() != _ABI_VERSION:
            log.warning("native pool index: ABI version mismatch")
            return None
        _LIB = lib
        return _LIB


def _i32(blocks: Sequence[int]):
    """`blocks` as a C int32 array (a ctypes array passes as the pointer;
    cheaper than a numpy array for the few blocks of a request)."""
    return (ctypes.c_int32 * len(blocks))(*blocks)


class NativePoolIndex:
    """Allocator + prefix index in the C++ core (csrc/kvpool.cpp)."""

    kind = "native"

    def __init__(self, n_blocks: int, lib):
        self._lib = lib
        self._h = lib.tg_pool_create(n_blocks)
        self.n_blocks = n_blocks

    def __del__(self):
        # at interpreter exit the library's globals may already be gone
        try:
            if self._h:
                self._lib.tg_pool_destroy(self._h)
                self._h = None
        except Exception:
            pass

    @property
    def n_free(self) -> int:
        return int(self._lib.tg_pool_n_free(self._h))

    @property
    def n_idle_cached(self) -> int:
        return int(self._lib.tg_pool_n_idle_cached(self._h))

    def alloc(self, n: int) -> Optional[List[int]]:
        out = (ctypes.c_int32 * max(n, 1))()
        if self._lib.tg_pool_alloc(self._h, n, out) != 0:
            return None
        return out[:n]

    def share(self, blocks) -> None:
        if len(blocks):
            self._lib.tg_pool_share(self._h, _i32(blocks), len(blocks))

    def release(self, blocks, keep_cached=()) -> None:
        if not len(blocks):
            return
        keep = set(keep_cached)
        flags = (ctypes.c_uint8 * len(blocks))(*(b in keep for b in blocks))
        self._lib.tg_pool_release(self._h, _i32(blocks), flags, len(blocks))

    def register_prefix(self, h: int, block: int) -> None:
        # h is a 128-bit chain digest (scheduler._block_hashes): (hi, lo)
        self._lib.tg_pool_register_prefix(self._h, h >> 64 & _U64_MASK, h & _U64_MASK,
                                          block)

    def lookup_prefix(self, h: int) -> Optional[int]:
        b = self._lib.tg_pool_lookup_prefix(self._h, h >> 64 & _U64_MASK, h & _U64_MASK)
        return None if b < 0 else b

    def is_registered(self, block: int) -> bool:
        return bool(self._lib.tg_pool_block_is_registered(self._h, block))


class PythonPoolIndex:
    """Refcounted blocks, the idle-cached LRU tier for registered prompt
    prefixes, and the hash -> block prefix index, over BlockAllocator."""

    kind = "python"

    def __init__(self, n_blocks: int):
        self._a = BlockAllocator(n_blocks)
        self._prefix = {}
        self._block_hash = {}
        self.n_blocks = n_blocks

        def on_evict(b):
            h = self._block_hash.pop(b, None)
            if h is not None:
                self._prefix.pop(h, None)

        self._a.on_evict = on_evict

    @property
    def n_free(self) -> int:
        return self._a.n_free

    @property
    def n_idle_cached(self) -> int:
        return len(self._a.cached_idle)

    def alloc(self, n: int) -> Optional[List[int]]:
        return self._a.alloc(n)

    def share(self, blocks) -> None:
        self._a.share(list(blocks))

    def release(self, blocks, keep_cached=()) -> None:
        self._a.release(list(blocks), keep_cached=keep_cached)

    def register_prefix(self, h: int, block: int) -> None:
        # h is a 128-bit chain digest (scheduler._block_hashes)
        if h not in self._prefix:
            self._prefix[h] = block
            self._block_hash[block] = h

    def lookup_prefix(self, h: int) -> Optional[int]:
        return self._prefix.get(h)

    def is_registered(self, block: int) -> bool:
        return block in self._block_hash


def create_pool_index(n_blocks: int):
    """The pool index of `n_blocks` blocks: NativePoolIndex when the C++
    core builds and loads (and TINYGPT_NO_NATIVE is unset), else
    PythonPoolIndex, with a warning when the core was wanted."""
    from tinygpt_tpu_torch.ops.host_build import native_disabled

    if not native_disabled():
        lib = _load()
        if lib is not None:
            return NativePoolIndex(n_blocks, lib)
        log.warning("native pool index unavailable: using the Python index")
    return PythonPoolIndex(n_blocks)
