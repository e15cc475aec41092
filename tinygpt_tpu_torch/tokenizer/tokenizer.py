"""Tokenizer facade.

Capability parity with TinyGPT's src/tokenizer/Tokenizer.{h,cpp}:
the 5-stage HF pipeline (normalizer → pre-tokenizer → model →
post-processor → decoder), added/special-token splitting via one
alternation regex, bos/eos/pad handling, UTF-8-safe streaming decode, and
parallel batch encode/decode. Plus `apply_chat_template` (Jinja).
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

import re

from tinygpt_tpu_torch.tokenizer.chat_template import (
    CHATML_TEMPLATE,
    ChatTemplate,
)
from tinygpt_tpu_torch.tokenizer.config import (
    AddedToken,
    TokenizerConfig,
    load_tokenizer_config,
)
from tinygpt_tpu_torch.utils.logging import get_logger

log = get_logger("tokenizer")

_RESERVED_RE = re.compile(r"^<\|reserved_special_token_\d+\|>$")


def _build_added_token_regex(tokens: List[AddedToken]):
    """One alternation regex over added-token contents, longest first
    (reference: Tokenizer.cpp:269-303). lstrip/rstrip extend the match over
    adjacent whitespace; single_word requires non-word boundaries.
    HF `reserved_special_token` placeholders are excluded from splitting
    (reference: Tokenizer.cpp:45-51) but stay decodable by id."""
    alts = []
    for t in sorted(tokens, key=lambda t: -len(t.content)):
        if _RESERVED_RE.match(t.content):
            continue
        pat = re.escape(t.content)
        if t.lstrip:
            pat = r"\s*" + pat
        if t.rstrip:
            pat = pat + r"\s*"
        if t.single_word:
            pat = r"(?<!\w)" + pat + r"(?!\w)"
        alts.append(pat)
    if not alts:
        return None
    return re.compile("|".join(alts))


class DecodeStream:
    """Incremental UTF-8-safe detokenizer (reference:
    Tokenizer.cpp:206-267 decodeStream/decodeStreamFlush).

    Uses the prefix-window algorithm: re-decode a short window ending at
    the new token and emit only the stable suffix, holding back text that
    ends in an incomplete UTF-8 sequence (surfaced as U+FFFD)."""

    def __init__(self, tokenizer: "Tokenizer", skip_special_tokens: bool = False):
        self._tok = tokenizer
        self._skip_special = skip_special_tokens
        self._ids: List[int] = []
        self._prefix_index = 0  # window start
        self._read_index = 0  # ids before this were already emitted

    def step(self, token_id: int) -> str:
        self._ids.append(token_id)
        window = self._ids[self._prefix_index:]
        prefix_text = self._tok.decode(
            self._ids[self._prefix_index : self._read_index],
            skip_special_tokens=self._skip_special,
            _streaming=True,
        )
        text = self._tok.decode(
            window, skip_special_tokens=self._skip_special, _streaming=True
        )
        if text.endswith("�"):
            # incomplete UTF-8 from a partial byte-level/byte-fallback char
            return ""
        chunk = text[len(prefix_text):]
        self._prefix_index = self._read_index
        self._read_index = len(self._ids)
        return chunk

    def flush(self) -> str:
        window = self._ids[self._prefix_index:]
        prefix_text = self._tok.decode(
            self._ids[self._prefix_index : self._read_index],
            skip_special_tokens=self._skip_special,
            _streaming=True,
        )
        text = self._tok.decode(
            window, skip_special_tokens=self._skip_special, _streaming=True
        )
        self._prefix_index = self._read_index = len(self._ids)
        return text[len(prefix_text):]


class Tokenizer:
    """HF-tokenizers-compatible tokenizer."""

    def __init__(self, config: TokenizerConfig):
        self.config = config
        self.model = config.model
        self.normalizer = config.normalizer
        self.pre_tokenizer = config.pre_tokenizer
        self.post_processor = config.post_processor
        self.decoder = config.decoder

        self._added_by_content: Dict[str, AddedToken] = {
            t.content: t for t in config.added_tokens
        }
        self._added_by_id: Dict[int, AddedToken] = {
            t.id: t for t in config.added_tokens
        }
        self._special_ids = {t.id for t in config.added_tokens if t.special}
        self._id_to_token: Dict[int, str] = dict(self.model.id_to_token)
        for t in config.added_tokens:
            self._id_to_token[t.id] = t.content
        self._token_to_id: Dict[str, int] = dict(self.model.vocab)
        for t in config.added_tokens:
            self._token_to_id[t.content] = t.id

        raw = [t for t in config.added_tokens if not t.normalized]
        normed = [t for t in config.added_tokens if t.normalized]
        self._added_re_raw = _build_added_token_regex(raw)
        self._added_re_norm = _build_added_token_regex(normed)

        self._chat_template: Optional[ChatTemplate] = None
        if config.chat_template:
            self._chat_template = ChatTemplate(
                config.chat_template,
                bos_token=config.bos_token or "",
                eos_token=config.eos_token or "",
                pad_token=config.pad_token or "",
                unk_token=config.unk_token or "",
            )

        # native (C++) fast path, decided on first use; None keeps
        # everything on the pure-Python pipeline
        self._native = None
        self._native_tried = False

    @property
    def native_encoder(self):
        """The C++ encoder core (tokenizer/native.py) when this tokenizer
        fits its fast path and the core builds, else None: built once per
        instance, on first use."""
        if not self._native_tried:
            self._native_tried = True
            try:
                from tinygpt_tpu_torch.tokenizer.native import build_native_encoder

                self._native = build_native_encoder(self)
            except Exception as e:  # never break tokenization
                log.warning("native tokenizer unavailable: %s", e)
                self._native = None
        return self._native

    # -- constructors --------------------------------------------------

    @classmethod
    def from_files(cls, tokenizer_json: str,
                   tokenizer_config_json: Optional[str] = None) -> "Tokenizer":
        return cls(load_tokenizer_config(tokenizer_json, tokenizer_config_json))

    @classmethod
    def from_dir(cls, model_dir: str) -> "Tokenizer":
        tj = os.path.join(model_dir, "tokenizer.json")
        tc = os.path.join(model_dir, "tokenizer_config.json")
        if not os.path.exists(tj):
            raise FileNotFoundError(f"{tj} not found")
        return cls.from_files(tj, tc if os.path.exists(tc) else None)

    # -- vocab accessors -------------------------------------------------

    @property
    def vocab_size(self) -> int:
        return max(len(self._token_to_id), 1 + max(self._id_to_token, default=0))

    def token_to_id(self, token: str) -> Optional[int]:
        return self._token_to_id.get(token)

    def id_to_token(self, token_id: int) -> Optional[str]:
        return self._id_to_token.get(token_id)

    def _cfg_token_id(self, content: Optional[str]) -> Optional[int]:
        if content is None:
            return None
        return self._token_to_id.get(content)

    @property
    def bos_token_id(self) -> Optional[int]:
        return self._cfg_token_id(self.config.bos_token)

    @property
    def eos_token_id(self) -> Optional[int]:
        return self._cfg_token_id(self.config.eos_token)

    @property
    def pad_token_id(self) -> Optional[int]:
        return self._cfg_token_id(self.config.pad_token)

    @property
    def bos_token(self) -> Optional[str]:
        return self.config.bos_token

    @property
    def eos_token(self) -> Optional[str]:
        return self.config.eos_token

    @property
    def pad_token(self) -> Optional[str]:
        return self.config.pad_token

    @property
    def special_token_ids(self) -> set:
        return set(self._special_ids)

    # -- encode ------------------------------------------------------------

    def _split_added(self, text: str, pattern) -> List[Tuple[bool, str]]:
        """Split into (is_added, segment) preserving order."""
        if pattern is None or not text:
            return [(False, text)] if text else []
        out: List[Tuple[bool, str]] = []
        pos = 0
        for m in pattern.finditer(text):
            if m.start() > pos:
                out.append((False, text[pos : m.start()]))
            out.append((True, m.group().strip() if m.group() not in
                        self._added_by_content else m.group()))
            pos = m.end()
        if pos < len(text):
            out.append((False, text[pos:]))
        return out

    def _encode_segment(self, text: str, is_first: bool) -> List[int]:
        """normalize → (split on normalized added tokens) → pre-tokenize →
        model, for one plain-text segment. `is_first` marks the segment at
        offset 0 of the original text (Metaspace "first" prepend scheme
        keys off the original offset)."""
        if self.normalizer is not None:
            text = self.normalizer.normalize(text)
        parts = self._split_added(text, self._added_re_norm)
        ids: List[int] = []
        for is_added, seg in parts:
            if is_added:
                ids.append(self._added_by_content[seg].id)
                is_first = False
                continue
            pieces = [seg]
            if self.pre_tokenizer is not None:
                pieces = self.pre_tokenizer.pre_tokenize(pieces, is_first=is_first)
            is_first = False
            for piece in pieces:
                ids.extend(self.model.tokenize(piece))
        return ids

    def _segment_items(self, text: str) -> List[Tuple[Optional[int], str]]:
        """Fully split `text` into (added_token_id, '') and (None, plain)
        items, applying both the raw and normalized added-token splits.
        Only valid when there is no normalizer (the native path's
        precondition), so split order cannot change results."""
        items: List[Tuple[Optional[int], str]] = []
        for is_added, seg in self._split_added(text, self._added_re_raw):
            if is_added:
                items.append((self._added_by_content[seg].id, ""))
                continue
            for is_a2, seg2 in self._split_added(seg, self._added_re_norm):
                if is_a2:
                    items.append((self._added_by_content[seg2].id, ""))
                else:
                    items.append((None, seg2))
        return items

    def _encode_native(self, texts: Sequence[str],
                       num_threads: int = 0) -> List[List[int]]:
        """Batch encode through the C++ core: Python does the added-token
        splits, C++ does split-pattern matching + BPE for every plain
        segment of every text in one GIL-free call."""
        per_text = [self._segment_items(t) for t in texts]
        transform = self.native_encoder.transform
        segments = []
        for items in per_text:
            for idx, (tid, seg) in enumerate(items):
                if tid is None:
                    if transform is not None:
                        seg = transform(seg, idx == 0)
                    segments.append(seg)
        encoded = self.native_encoder.encode_segments(
            segments, num_threads=num_threads
        )
        out: List[List[int]] = []
        k = 0
        for items in per_text:
            ids: List[int] = []
            for tid, _seg in items:
                if tid is not None:
                    ids.append(tid)
                else:
                    ids.extend(encoded[k])
                    k += 1
            out.append(ids)
        return out

    def _finish_encode(self, ids: List[int],
                       add_special_tokens: bool) -> List[int]:
        if self.post_processor is not None:
            ids = self.post_processor.process(
                ids, add_special_tokens=add_special_tokens
            )
        elif add_special_tokens:
            # slow-tokenizer style flags when no template exists
            if self.config.add_bos_token and self.bos_token_id is not None:
                ids = [self.bos_token_id] + ids
            if self.config.add_eos_token and self.eos_token_id is not None:
                ids = ids + [self.eos_token_id]
        return ids

    def encode(self, text: str, add_special_tokens: bool = True) -> List[int]:
        if self.native_encoder is not None:
            ids = self._encode_native([text], num_threads=1)[0]
            return self._finish_encode(ids, add_special_tokens)
        ids: List[int] = []
        first = True
        for is_added, seg in self._split_added(text, self._added_re_raw):
            if is_added:
                ids.append(self._added_by_content[seg].id)
                first = False
            else:
                ids.extend(self._encode_segment(seg, is_first=first))
                first = False
        return self._finish_encode(ids, add_special_tokens)

    def encode_batch(self, texts: Sequence[str], add_special_tokens: bool = True,
                     num_threads: int = 0) -> List[List[int]]:
        """Parallel batch encode (reference: thread pool,
        Tokenizer.cpp:333-397). With the native core, all segments of all
        texts go through one GIL-free C++ call fanned over a thread pool;
        the pure-Python fallback uses a ThreadPoolExecutor (GIL-bound)."""
        if self.native_encoder is not None and texts:
            batch = self._encode_native(texts, num_threads=num_threads)
            return [
                self._finish_encode(ids, add_special_tokens) for ids in batch
            ]
        if num_threads and len(texts) > 1:
            with ThreadPoolExecutor(max_workers=num_threads) as ex:
                return list(
                    ex.map(lambda t: self.encode(t, add_special_tokens), texts)
                )
        return [self.encode(t, add_special_tokens) for t in texts]

    # -- decode --------------------------------------------------------

    def decode(self, ids: Iterable[int], skip_special_tokens: bool = False,
               _streaming: bool = False) -> str:
        tokens: List[str] = []
        for i in ids:
            i = int(i)
            if skip_special_tokens and i in self._special_ids:
                continue
            added = self._added_by_id.get(i)
            if added is not None and added.id not in self.model.id_to_token:
                tokens.append(added.content)
                continue
            t = self._id_to_token.get(i)
            if t is not None:
                tokens.append(t)
        if self.decoder is not None:
            tokens = self.decoder.decode_chain(tokens)
        return "".join(tokens)

    def decode_batch(self, batches: Sequence[Sequence[int]],
                     skip_special_tokens: bool = False,
                     num_threads: int = 0) -> List[str]:
        if num_threads and len(batches) > 1:
            with ThreadPoolExecutor(max_workers=num_threads) as ex:
                return list(
                    ex.map(lambda b: self.decode(b, skip_special_tokens), batches)
                )
        return [self.decode(b, skip_special_tokens) for b in batches]

    def decode_stream(self, skip_special_tokens: bool = False) -> DecodeStream:
        return DecodeStream(self, skip_special_tokens)

    # -- chat template ---------------------------------------------------

    @property
    def has_chat_template(self) -> bool:
        return self._chat_template is not None

    def set_chat_template(self, template: str) -> None:
        self._chat_template = ChatTemplate(
            template,
            bos_token=self.config.bos_token or "",
            eos_token=self.config.eos_token or "",
            pad_token=self.config.pad_token or "",
            unk_token=self.config.unk_token or "",
        )

    def supports_chatml_fallback(self) -> bool:
        """True when <|im_start|>/<|im_end|> are single vocab tokens, the
        reference's condition for falling back to ChatML
        (server/HttpServer.cpp:47-58)."""
        return (
            self.token_to_id("<|im_start|>") is not None
            and self.token_to_id("<|im_end|>") is not None
        )

    def apply_chat_template(
        self,
        messages: List[Dict[str, Any]],
        add_generation_prompt: bool = False,
        tools: Optional[list] = None,
        **extra,
    ) -> str:
        if self._chat_template is None:
            if self.supports_chatml_fallback():
                self.set_chat_template(CHATML_TEMPLATE)
            else:
                raise ValueError("tokenizer has no chat template")
        return self._chat_template.render(
            messages, add_generation_prompt=add_generation_prompt,
            tools=tools, **extra,
        )
