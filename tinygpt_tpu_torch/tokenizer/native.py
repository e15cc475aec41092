"""ctypes binding for the native tokenizer core (csrc/tokenizer.cpp).

Counterpart of tinygpt_tpu/tokenizer/native.py. The native core covers the
byte-level-BPE family (GPT-2 / Llama-3 / Qwen-2/3 tokenizer.json layouts:
no normalizer, a known split pattern, a complete byte alphabet, plain BPE
merges) and the sentencepiece-converted Metaspace family (Mistral-v0.3,
Llama-2). Everything else stays on the pure-Python pipeline: eligibility
is decided once per Tokenizer by `build_native_encoder`, which returns
None whenever anything falls outside the fast path (or the library cannot
be built, or TINYGPT_NO_NATIVE is set). Only the two hot loops live in C++
(split matching and BPE merges); added-token splitting, post-processing
and decoding stay in Python. The library is built by ``ops/host_build.py``
from the port's own ``csrc/tokenizer.cpp`` at first use.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import List, Optional, Sequence

import numpy as np

from tinygpt_tpu_torch.utils.logging import get_logger

log = get_logger("tokenizer.native")

_LIB_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_LIB_TRIED = False
_ABI_VERSION = 2

# Known split patterns -> pretok kind in csrc/tokenizer.cpp.
_GPT2_PATTERNS = {
    r"""'(?:[sdmt]|ll|ve|re)| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""",
    r"""'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+""",
}
# canonical + possessive-quantifier spelling (same matched language)
_LLAMA3_PATTERNS = {
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+",
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?+\p{L}+|\p{N}{1,3}"
    r"| ?[^\s\p{L}\p{N}]++[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+",
}
_QWEN2_PATTERN = (
    r"(?i:'s|'t|'re|'ve|'m|'ll|'d)|[^\r\n\p{L}\p{N}]?\p{L}+|\p{N}"
    r"| ?[^\s\p{L}\p{N}]+[\r\n]*|\s*[\r\n]+|\s+(?!\S)|\s+"
)

KIND_NONE = 0
KIND_GPT2 = 1
KIND_LLAMA3 = 2
KIND_QWEN2 = 3
KIND_METASPACE = 4


def _load_library() -> Optional[ctypes.CDLL]:
    """The tokenizer library with its C signatures declared, or None when
    it cannot be built or loaded (logged once)."""
    global _LIB, _LIB_TRIED
    with _LIB_LOCK:
        if _LIB is not None or _LIB_TRIED:
            return _LIB
        _LIB_TRIED = True
        from tinygpt_tpu_torch.ops import host_build

        lib = host_build.load("tokenizer.cpp")
        if lib is None:
            return None
        u32p, u64p = ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint64)
        lib.tg_tok_create.restype = ctypes.c_void_p
        lib.tg_tok_create.argtypes = [
            ctypes.c_char_p, ctypes.c_uint64, ctypes.c_uint32,
            u32p, ctypes.c_uint32,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int32, ctypes.c_int, ctypes.c_int,
            ctypes.c_char_p, ctypes.c_uint32,
        ]
        lib.tg_tok_destroy.argtypes = [ctypes.c_void_p]
        lib.tg_tok_destroy.restype = None
        lib.tg_tok_encode_batch.restype = ctypes.c_int64
        lib.tg_tok_encode_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_char_p, u64p, ctypes.c_uint32,
            u32p, ctypes.c_uint64, u64p, ctypes.c_int,
        ]
        lib.tg_tok_abi_version.argtypes, lib.tg_tok_abi_version.restype = [], ctypes.c_int
        if lib.tg_tok_abi_version() != _ABI_VERSION:
            log.warning("native tokenizer: ABI version mismatch")
            return None
        _LIB = lib
        return _LIB


class NativeEncoder:
    """Encodes plain-text segments through the C++ core.

    `transform`, when set, must be applied by the caller to each segment
    BEFORE encode_segments: transform(segment, is_first) -> str. The
    Metaspace family uses it for the space -> replacement mapping and the
    prepend scheme; the C++ side then does char-alphabet BPE and byte
    fallback. `kind` is the core's pre-tokenizer kind (KIND_*)."""

    def __init__(self, handle: int, lib: ctypes.CDLL, kind: int, transform=None):
        self._h = handle
        self._lib = lib
        self.kind = kind
        self.transform = transform

    def __del__(self):
        # at interpreter exit the library's globals may already be gone
        try:
            if self._h:
                self._lib.tg_tok_destroy(self._h)
                self._h = None
        except Exception:
            pass

    def encode_segments(
        self, segments: Sequence[str], num_threads: int = 0
    ) -> List[List[int]]:
        """Ids of each segment, in one call into the core (which releases
        the GIL and fans the segments over `num_threads` threads, all cores
        at 0)."""
        if not segments:
            return []
        encoded = [s.encode("utf-8") for s in segments]
        data = b"".join(encoded)
        offsets = np.zeros(len(segments) + 1, dtype=np.uint64)
        np.cumsum([len(b) for b in encoded], out=offsets[1:])
        # worst case one id per input byte, +1 per segment (prefix space)
        cap = max(16, len(data) + len(segments))
        out = np.empty(cap, dtype=np.uint32)
        out_offsets = np.zeros(len(segments), dtype=np.uint64)
        n = self._lib.tg_tok_encode_batch(
            self._h,
            data,
            offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            len(segments),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
            cap,
            out_offsets.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            num_threads or os.cpu_count() or 1,
        )
        if n < 0:
            raise RuntimeError("native tokenizer output overflow")
        ends = out_offsets.tolist()
        return [out[s:e].tolist() for s, e in zip([0] + ends[:-1], ends)]


def _detect_pretok(tokenizer) -> Optional[tuple]:
    """Map the tokenizer's pre-tokenizer onto (kind, add_prefix_space),
    or None when it is not one of the fixed fast-path patterns."""
    from tinygpt_tpu_torch.tokenizer.byte_level import ByteLevelPreTokenizer
    from tinygpt_tpu_torch.tokenizer.split import SplitPreTokenizer

    pt = tokenizer.pre_tokenizer
    if pt is None:
        return None
    if isinstance(pt, ByteLevelPreTokenizer):
        if not pt.use_regex:
            return (KIND_NONE, pt.add_prefix_space)
        return (KIND_GPT2, pt.add_prefix_space)
    parts = getattr(pt, "parts", None)
    if parts is None:
        return None
    # Sequence[Split(known regex, Isolated), ByteLevel(use_regex=False)]
    if len(parts) != 2:
        return None
    sp, bl = parts
    if not isinstance(sp, SplitPreTokenizer) or not isinstance(
        bl, ByteLevelPreTokenizer
    ):
        return None
    if sp.invert or sp.behavior != "Isolated" or bl.use_regex:
        return None
    pat = sp.pattern_str
    if pat in _GPT2_PATTERNS:
        return (KIND_GPT2, bl.add_prefix_space)
    if pat in _LLAMA3_PATTERNS:
        return (KIND_LLAMA3, bl.add_prefix_space)
    if pat == _QWEN2_PATTERN:
        return (KIND_QWEN2, bl.add_prefix_space)
    return None


def _detect_metaspace(tokenizer) -> Optional[tuple]:
    """Detect the sentencepiece-converted BPE family (Mistral-v0.3,
    Llama-2 layouts). Returns (replacement, prepend_scheme, split,
    unconditional_prepend) or None.

    Two equivalent pipeline spellings exist in the wild:
      * pre_tokenizer Metaspace (replacement/prepend_scheme/split),
        normalizer None — Mistral-7B-v0.3;
      * normalizer Sequence[Prepend(rep), Replace(' '->rep)],
        pre_tokenizer None — Llama-2. The Prepend normalizer applies to
        every segment unconditionally (vs Metaspace's
        only-if-not-already-prefixed, first-segment-only default).
    """
    from tinygpt_tpu_torch.tokenizer.metaspace import Metaspace
    from tinygpt_tpu_torch.tokenizer.normalizers import (
        NormalizerSequence,
        PrependNormalizer,
        ReplaceNormalizer,
    )

    pt, nm = tokenizer.pre_tokenizer, tokenizer.normalizer
    if isinstance(pt, Metaspace) and nm is None:
        return (pt.replacement, pt.prepend_scheme, pt.split, False)
    if pt is None and isinstance(nm, NormalizerSequence):
        parts = nm.normalizers
        if (
            len(parts) == 2
            and isinstance(parts[0], PrependNormalizer)
            and isinstance(parts[1], ReplaceNormalizer)
            and parts[1]._literal == " "
            and parts[1].content == parts[0].prepend
        ):
            return (parts[0].prepend, "always", False, True)
    return None


def _metaspace_transform(rep: str, scheme: str, uncond: bool):
    def transform(seg: str, is_first: bool) -> str:
        seg = seg.replace(" ", rep)
        if uncond:
            return rep + seg if seg else seg
        if scheme == "always" or (scheme == "first" and is_first):
            if not seg.startswith(rep):
                seg = rep + seg
        return seg

    return transform


def build_native_encoder(tokenizer) -> Optional[NativeEncoder]:
    """A NativeEncoder when `tokenizer` fits a fast path and the core
    loads, else None."""
    from tinygpt_tpu_torch.ops.host_build import native_disabled
    from tinygpt_tpu_torch.tokenizer.bpe import BPE
    from tinygpt_tpu_torch.tokenizer.byte_level import unicode_str_to_bytes

    if native_disabled():
        return None
    model = tokenizer.model
    if not isinstance(model, BPE):
        return None
    if model.continuing_subword_prefix or model.end_of_word_suffix:
        return None

    meta = _detect_metaspace(tokenizer)
    transform = None
    if meta is not None:
        replacement, scheme, split, uncond = meta
        if uncond:
            # normalizer form splits added tokens on normalized content
            # AFTER normalizing; skipping that re-split is only safe when
            # no added token can be (un)made by the transform
            for t in tokenizer._added_by_content:
                if " " in t or replacement in t:
                    return None
        kind, add_prefix_space = KIND_METASPACE, False
        rep = replacement
        transform = _metaspace_transform(rep, scheme, uncond)
        token_bytes = lambda s: s.encode("utf-8")  # noqa: E731
        ms_split, byte_fallback, fuse_unk = split, model.byte_fallback, \
            model.fuse_unk
        unk_id = model.vocab.get(model.unk_token, -1) \
            if model.unk_token else -1
    else:
        if model.byte_fallback or model.unk_token:
            return None
        if tokenizer.normalizer is not None:
            return None
        pre = _detect_pretok(tokenizer)
        if pre is None:
            return None
        kind, add_prefix_space = pre
        token_bytes = unicode_str_to_bytes
        rep = ""
        ms_split, byte_fallback, fuse_unk, unk_id = False, False, False, -1

    vocab = model.vocab
    n_tokens = max(vocab.values()) + 1 if vocab else 0
    if n_tokens == 0 or n_tokens > 4_000_000:
        return None
    lib = _load_library()
    if lib is None:
        return None
    raw: List[bytes] = [b""] * n_tokens  # unused ids stay empty
    for tok_str, tid in vocab.items():
        if 0 <= tid < n_tokens:
            raw[tid] = token_bytes(tok_str)
    blob = b"".join(len(b).to_bytes(4, "little") + b for b in raw)

    merges = np.zeros(max(len(model.merge_ranks), 1) * 3, dtype=np.uint32)
    items = sorted(model.merge_ranks.items(), key=lambda kv: kv[1])
    kept = 0
    for (a, b), _rank in items:
        ia, ib = vocab.get(a), vocab.get(b)
        im = vocab.get(a + b)
        if ia is None or ib is None or im is None:
            continue  # unusable merge (HF drops these too)
        merges[kept * 3 : kept * 3 + 3] = (ia, ib, im)
        kept += 1

    rep_bytes = rep.encode("utf-8")
    handle = lib.tg_tok_create(
        blob,
        len(blob),
        n_tokens,
        merges.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        kept,
        kind,
        int(add_prefix_space),
        int(model.ignore_merges),
        int(byte_fallback),
        int(unk_id),
        int(fuse_unk),
        int(ms_split),
        rep_bytes,
        len(rep_bytes),
    )
    if not handle:
        return None
    log.info(
        "native tokenizer active: kind=%d vocab=%d merges=%d",
        kind, n_tokens, kept,
    )
    return NativeEncoder(handle, lib, kind, transform=transform)
