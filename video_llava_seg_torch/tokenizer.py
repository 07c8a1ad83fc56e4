"""A checkpoint's `tokenizer.json` read without `transformers` (the port's
counterpart of what the JAX package takes from `AutoTokenizer`; the
machine with the card has neither `transformers`, `tokenizers` nor
`regex`). Standard library and numpy only.

    tok = Tokenizer.from_pretrained("<checkpoint dir>")
    tok("<|start_header_id|>user").input_ids, tok.decode(ids)

Covers the BPE tokenizers of the families the repo supports:
- Llama-3: byte-level BPE, a `Split` pre-tokenizer on the Llama-3 pattern
  then `ByteLevel(use_regex=false)`, `ignore_merges`, a
  `TemplateProcessing` BOS;
- Llama-2, Vicuna, Mistral: SentencePiece-style BPE with `byte_fallback`,
  the spaces by a `Metaspace` pre-tokenizer or a `Prepend("▁")` +
  `Replace(" ", "▁")` normalizer, the decoder `Replace` / `ByteFallback`
  / `Fuse` / `Strip`, BOS from `add_bos_token`;
- MPT (GPT-NeoX): NFC, byte-level BPE on the GPT-2 pattern, no BOS.

The pipeline is the `tokenizers` library's: added tokens are split out
first (longest match first, on the raw text unless `normalized`), then
each remaining piece is normalized, pre-tokenized and run through the BPE
merges by rank (leftmost first). `\\p{L}` / `\\p{N}` / `\\s` of the
patterns become explicit code-point classes: the Unicode general
categories L* / N* of `unicodedata` and the White_Space property (what
oniguruma's `\\s` matches). Python 3.12's `unicodedata` is Unicode 15.0;
code points assigned later are unassigned here.

A directory holding only `tokenizer.model` (a SentencePiece protobuf) is
refused, as is a name that is not a local directory: nothing is fetched.
"""

from __future__ import annotations

import functools
import heapq
import json
import os.path as osp
import re
import unicodedata
from typing import Dict, Iterable, List, Optional, Tuple

#: transformers' model_max_length when the config gives none
VERY_LARGE_INTEGER = int(1e30)

#: the Unicode White_Space property (oniguruma's `\s`; Python's adds
#: U+001C-U+001F)
_WHITESPACE = ("\\t\\n\\x0b\\x0c\\r \\x85\\xa0\\u1680\\u2000-\\u200a"
               "\\u2028\\u2029\\u202f\\u205f\\u3000")

#: the pre-tokenizer pattern of `ByteLevel(use_regex=true)` (GPT-2)
GPT2_PATTERN = (r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+"
                r"| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+")

#: the tokenizer classes whose post-processor transformers rebuilds from
#: `add_bos_token` / `add_eos_token` (their defaults), and those that
#: carry a `legacy` attribute (default True)
_BOS_EOS_CLASSES = {"LlamaTokenizer": (True, False),
                    "GPTNeoXTokenizer": (False, False)}
_LEGACY_CLASSES = ("LlamaTokenizer",)
_SPECIAL_KEYS = ("bos_token", "eos_token", "unk_token", "sep_token",
                 "pad_token", "cls_token", "mask_token")


# ---------------------------------------------------------------------------
# patterns
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _category_class(prefix: str) -> str:
    """The code points whose general category starts with `prefix`, as
    the inside of a regex character class (ranges of \\U escapes)."""
    parts, start, prev = [], None, None
    for cp in range(0x110000):
        if unicodedata.category(chr(cp)).startswith(prefix):
            if start is None:
                start = cp
            prev = cp
        elif start is not None:
            parts.append(f"\\U{start:08x}" if start == prev
                         else f"\\U{start:08x}-\\U{prev:08x}")
            start = None
    if start is not None:
        parts.append(f"\\U{start:08x}-\\U{prev:08x}")
    return "".join(parts)


@functools.lru_cache(maxsize=64)
def compile_pattern(pattern: str) -> "re.Pattern":
    """An oniguruma pattern of a tokenizer.json as a Python `re` pattern:
    `\\p{L}`, `\\p{N}`, `\\s` and `\\S` become explicit classes; any
    other Unicode property or `\\d` / `\\w` class is refused."""
    out, i, in_class = [], 0, False
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            nxt = pattern[i + 1]
            if nxt == "p" and pattern.startswith("{", i + 2):
                end = pattern.index("}", i)
                prop = pattern[i + 3:end]
                if prop not in ("L", "N"):
                    raise NotImplementedError(
                        f"tokenizer pattern: \\p{{{prop}}} is not supported")
                body = _category_class(prop)
                out.append(body if in_class else f"[{body}]")
                i = end + 1
                continue
            if nxt == "s":
                out.append(_WHITESPACE if in_class else f"[{_WHITESPACE}]")
                i += 2
                continue
            if nxt == "S":
                if in_class:
                    raise NotImplementedError(
                        "tokenizer pattern: \\S inside a class")
                out.append(f"[^{_WHITESPACE}]")
                i += 2
                continue
            if nxt in "dDwWhHP":
                raise NotImplementedError(
                    f"tokenizer pattern: \\{nxt} is not supported")
            out.append(pattern[i:i + 2])
            i += 2
            continue
        if c == "[" and not in_class:
            in_class = True
            out.append(c)
            if pattern.startswith("^", i + 1):
                out.append("^")
                i += 1
            if pattern.startswith("]", i + 1):  # a literal ] first
                out.append("\\]")
                i += 1
        elif c == "]" and in_class:
            in_class = False
            out.append(c)
        else:
            out.append(c)
        i += 1
    return re.compile("".join(out))


def _segments(text: str, regex) -> List[Tuple[int, int, bool]]:
    """(start, end, is_match) covering `text` (tokenizers' find_matches)."""
    if not text:
        return [(0, 0, False)]
    segs, prev = [], 0
    for m in regex.finditer(text):
        s, e = m.span()
        if s == e:
            continue
        if prev != s:
            segs.append((prev, s, False))
        segs.append((s, e, True))
        prev = e
    if prev != len(text):
        segs.append((prev, len(text), False))
    return segs


def _split(text: str, segs, behavior: str) -> List[Tuple[str, int]]:
    """Pieces (text, start) of `text` by the matched segments and a
    SplitDelimiterBehavior (Isolated: every segment a piece;
    MergedWithNext: each match joins the segment after it); empty pieces
    dropped."""
    behavior = behavior.lower()
    if behavior == "isolated":
        spans = [(s, e) for s, e, _ in segs]
    elif behavior == "mergedwithnext":
        spans, prev_match = [], False
        for s, e, m in reversed(segs):
            if m and not prev_match and spans:
                spans[-1] = (s, spans[-1][1])
            else:
                spans.append((s, e))
            prev_match = m
        spans.reverse()
    else:
        raise NotImplementedError(f"split behavior {behavior!r}")
    return [(text[s:e], s) for s, e in spans if e > s]


def _char_segments(text: str, ch: str) -> List[Tuple[int, int, bool]]:
    """Every character a segment, matched where it is `ch`."""
    return [(i, i + 1, c == ch) for i, c in enumerate(text)]


@functools.lru_cache(maxsize=1)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's byte -> printable character map of the byte-level BPE."""
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return {b: chr(c) for b, c in zip(bs, cs)}


@functools.lru_cache(maxsize=1)
def _unicode_to_bytes() -> Dict[str, int]:
    return {c: b for b, c in bytes_to_unicode().items()}


# ---------------------------------------------------------------------------
# normalizers, pre-tokenizers, decoders (the tokenizer.json components)
# ---------------------------------------------------------------------------

def _pattern_of(spec) -> "re.Pattern":
    if "Regex" in spec:
        return compile_pattern(spec["Regex"])
    return re.compile(re.escape(spec["String"]))


def _build_normalizer(spec):
    """A str -> str function of a normalizer spec (None: identity)."""
    if spec is None:
        return None
    kind = spec["type"]
    if kind == "Sequence":
        parts = [_build_normalizer(s) for s in spec["normalizers"]]

        def seq(s):
            for p in parts:
                s = p(s)
            return s
        return seq
    if kind == "NFC":
        return functools.partial(unicodedata.normalize, kind)
    if kind == "Prepend":
        pre = spec["prepend"]
        return lambda s: pre + s if s else s
    if kind == "Replace":
        regex, content = _pattern_of(spec["pattern"]), spec["content"]
        return lambda s: regex.sub(lambda _: content, s)
    raise NotImplementedError(f"normalizer {kind!r}")


def _build_pre_tokenizer(spec):
    """A function [(text, at_start)] -> [(text, at_start)] of a
    pre-tokenizer spec; `at_start`: the piece begins the original text
    (Metaspace's prepend_scheme "first" reads it)."""
    if spec is None:
        return lambda pieces: pieces
    kind = spec["type"]

    def each(fn):
        def run(pieces):
            out = []
            for text, at_start in pieces:
                for k, (sub, pos) in enumerate(fn(text, at_start)):
                    out.append((sub, at_start and k == 0 and pos == 0))
            return out
        return run

    if kind == "Sequence":
        parts = [_build_pre_tokenizer(s) for s in spec["pretokenizers"]]

        def seq(pieces):
            for p in parts:
                pieces = p(pieces)
            return pieces
        return seq
    if kind == "Split":
        if spec.get("invert"):
            raise NotImplementedError("an inverted Split pre-tokenizer")
        regex, behavior = _pattern_of(spec["pattern"]), spec["behavior"]
        return each(lambda text, _: _split(text, _segments(text, regex),
                                           behavior))
    if kind == "ByteLevel":
        prefix = spec.get("add_prefix_space", False)
        regex = (compile_pattern(GPT2_PATTERN)
                 if spec.get("use_regex", True) else None)
        table = bytes_to_unicode()

        def byte_level(text, _):
            if prefix and not text.startswith(" "):
                text = " " + text
            pieces = ([(text, 0)] if regex is None else
                      _split(text, _segments(text, regex), "isolated"))
            return [("".join(table[b] for b in p.encode("utf-8")), pos)
                    for p, pos in pieces]
        return each(byte_level)
    if kind == "Metaspace":
        rep = spec.get("replacement", "▁")
        scheme = spec.get("prepend_scheme") or (
            "always" if spec.get("add_prefix_space", True) else "never")
        do_split = spec.get("split", True)

        def metaspace(text, at_start):
            text = text.replace(" ", rep)
            if not text.startswith(rep) and (
                    scheme == "always" or (scheme == "first" and at_start)):
                text = rep + text
            if not do_split:
                return [(text, 0)] if text else []
            return _split(text, _char_segments(text, rep), "mergedwithnext")
        return each(metaspace)
    raise NotImplementedError(f"pre-tokenizer {kind!r}")


def _byte_fallback(tokens: List[str]) -> List[str]:
    out, pending = [], []

    def flush():
        if pending:
            try:
                out.append(bytes(pending).decode("utf-8"))
            except UnicodeDecodeError:
                out.extend("�" for _ in pending)
            pending.clear()

    for t in tokens:
        if len(t) == 6 and t.startswith("<0x") and t.endswith(">"):
            try:
                pending.append(int(t[3:5], 16))
                continue
            except ValueError:
                pass
        flush()
        out.append(t)
    flush()
    return out


def _build_decoder(spec):
    """A function [token] -> [str] of a decoder spec (joined by the
    caller); None: the tokens joined by spaces."""
    if spec is None:
        return None
    kind = spec["type"]
    if kind == "Sequence":
        parts = [_build_decoder(s) for s in spec["decoders"]]

        def seq(tokens):
            for p in parts:
                tokens = p(tokens)
            return tokens
        return seq
    if kind == "ByteLevel":
        table = _unicode_to_bytes()

        def byte_level(tokens):
            buf = bytearray()
            for t in tokens:
                try:
                    buf.extend(table[c] for c in t)
                except KeyError:
                    buf.extend(t.encode("utf-8"))
            return [buf.decode("utf-8", errors="replace")]
        return byte_level
    if kind == "Replace":
        regex, content = _pattern_of(spec["pattern"]), spec["content"]
        return lambda tokens: [regex.sub(lambda _: content, t)
                               for t in tokens]
    if kind == "ByteFallback":
        return _byte_fallback
    if kind == "Fuse":
        return lambda tokens: ["".join(tokens)]
    if kind == "Strip":
        ch, start, stop = spec["content"], spec["start"], spec["stop"]

        def strip(tokens):
            out = []
            for t in tokens:
                a = 0
                while a < min(start, len(t)) and t[a] == ch:
                    a += 1
                b, k = len(t), 0
                while k < stop and b > a and t[b - 1] == ch:
                    b, k = b - 1, k + 1
                out.append(t[a:b])
            return out
        return strip
    raise NotImplementedError(f"decoder {kind!r}")


def clean_up_tokenization(text: str) -> str:
    """transformers' `clean_up_tokenization` (spaces before punctuation
    and English contractions)."""
    return (text.replace(" .", ".").replace(" ?", "?").replace(" !", "!")
            .replace(" ,", ",").replace(" ' ", "'").replace(" n't", "n't")
            .replace(" 'm", "'m").replace(" 's", "'s").replace(" 've", "'ve")
            .replace(" 're", "'re"))


def _token_content(value) -> Optional[str]:
    if isinstance(value, dict):
        return value.get("content")
    return value


class _Encoding:
    __slots__ = ("input_ids",)

    def __init__(self, input_ids):
        self.input_ids = input_ids


# ---------------------------------------------------------------------------
# the tokenizer
# ---------------------------------------------------------------------------

class Tokenizer:
    """The surface of a transformers fast tokenizer that both packages
    call: `__call__(text).input_ids`, `decode`, `convert_tokens_to_ids`,
    `add_tokens`, `bos_token_id` / `eos_token_id` / `pad_token_id`,
    `model_max_length`, `legacy` (Llama classes only, as transformers)
    and `len()`."""

    def __init__(self, spec: Dict, config: Optional[Dict] = None):
        config = dict(config or {})
        model = spec["model"]
        if model.get("type", "BPE") != "BPE":
            raise NotImplementedError(f"tokenizer model {model['type']!r}: "
                                      "only BPE is supported")
        if model.get("dropout"):
            raise NotImplementedError("BPE dropout")
        self._vocab: Dict[str, int] = dict(model["vocab"])
        self._id_to_token = {i: t for t, i in self._vocab.items()}
        self._unk = model.get("unk_token")
        self._fuse_unk = bool(model.get("fuse_unk", False))
        self._byte_fallback = bool(model.get("byte_fallback", False))
        self._ignore_merges = bool(model.get("ignore_merges", False))
        if model.get("continuing_subword_prefix") or \
                model.get("end_of_word_suffix"):
            raise NotImplementedError("BPE subword prefixes / suffixes")
        self._merges: Dict[Tuple[int, int], Tuple[int, int]] = {}
        for rank, m in enumerate(model.get("merges", [])):
            a, b = m.split(" ", 1) if isinstance(m, str) else m
            self._merges[(self._vocab[a], self._vocab[b])] = (
                rank, self._vocab[a + b])
        self._normalize = _build_normalizer(spec.get("normalizer"))
        self._pre_tokenize = _build_pre_tokenizer(spec.get("pre_tokenizer"))
        self._decoder = _build_decoder(spec.get("decoder"))
        self._cache: Dict[str, List[int]] = {}

        # added tokens: content -> id, flags
        self._added: Dict[str, int] = {}
        self._added_by_id: Dict[int, Dict] = {}
        self._matched_as: Dict[str, set] = {}
        self._special: set = set()
        # as tokenizers deserializes them: each takes its vocab id, or the
        # next id by `_add`'s rule, whatever id the file gives it
        for t in spec.get("added_tokens", []):
            self._add(t["content"], bool(t.get("special")), flags=t)

        cls = (config.get("tokenizer_class") or "").replace("Fast", "")
        self.model_max_length = int(config.get("model_max_length",
                                               VERY_LARGE_INTEGER))
        self.clean_up_tokenization_spaces = bool(
            config.get("clean_up_tokenization_spaces", False))
        if cls in _LEGACY_CLASSES:
            self.legacy = config.get("legacy")
            if self.legacy is None:
                self.legacy = True
        # specials named by the config (or its added_tokens_decoder) that
        # the tokenizer.json lacks are added, as transformers does
        self._tokens = {k: _token_content(config.get(k))
                        for k in _SPECIAL_KEYS}
        extra = [_token_content(t) for t in
                 config.get("additional_special_tokens") or []]
        decoder_tokens = sorted(
            (int(i), t) for i, t in
            (config.get("added_tokens_decoder") or {}).items())
        missing = [t for _, t in decoder_tokens
                   if t["content"] not in self._added]  # by content only
        for t in missing:
            self._add(t["content"], special=bool(t.get("special", False)),
                      flags=t)
        for name in [*self._tokens.values(), *extra]:
            if name is not None and name not in self._added:
                self._add(name, special=True)
        self._refresh()

        self._post = self._build_post_processor(spec.get("post_processor"),
                                                cls, config)

    # -- construction --------------------------------------------------

    @classmethod
    def from_pretrained(cls, path: str) -> "Tokenizer":
        """The tokenizer of a local checkpoint directory (tokenizer.json,
        and tokenizer_config.json where present)."""
        if not osp.isdir(path):
            raise OSError(
                f"tokenizer {path!r} is not a local directory: give the "
                "directory that holds the checkpoint's tokenizer.json "
                "(nothing is downloaded)")
        tj = osp.join(path, "tokenizer.json")
        if not osp.isfile(tj):
            if osp.isfile(osp.join(path, "tokenizer.model")):
                raise OSError(
                    f"{path} holds only tokenizer.model, a SentencePiece "
                    "protobuf, which this reader does not parse; provide "
                    "its tokenizer.json (transformers writes one: "
                    "AutoTokenizer.from_pretrained(dir).save_pretrained("
                    "dir))")
            raise FileNotFoundError(f"no tokenizer.json in {path}")
        with open(tj, encoding="utf-8") as fh:
            spec = json.load(fh)
        config = {}
        tc = osp.join(path, "tokenizer_config.json")
        if osp.isfile(tc):
            with open(tc, encoding="utf-8") as fh:
                config = json.load(fh)
        return cls(spec, config)

    def _register(self, t: Dict, tid: int):
        """Record an added token. A token added again with other flags
        keeps its id and takes the new flags, but still matches where the
        old ones did (tokenizers keeps both entries in its matchers)."""
        self._added[t["content"]] = tid
        self._matched_as.setdefault(t["content"], set()).add(
            bool(t.get("normalized", not t.get("special"))))
        self._added_by_id[tid] = dict(t)
        if t.get("special"):
            self._special.add(t["content"])

    def _add(self, content: str, special: bool, flags=None) -> bool:
        """tokenizers' AddedVocabulary.add_tokens for one token: False if
        an added token with the same content and flags exists; else its
        id is the added or vocab id it has, or one past the largest added
        id (the model's size when that is smaller), and its flags replace
        the old ones (a special token stays special)."""
        if not content:
            return False
        flags = dict(flags or {})
        if any(flags.get(k) for k in ("lstrip", "rstrip", "single_word")):
            raise NotImplementedError(f"added token {content!r}: lstrip / "
                                      "rstrip / single_word")
        tok = {"content": content, "special": special,
               "normalized": bool(flags.get("normalized", not special))}
        tid = self._added.get(content, self._vocab.get(content))
        if tid is not None and self._added_by_id.get(tid) == tok:
            return False
        if tid is None:
            base = len(self._vocab)
            top = max(self._added.values(), default=None)
            tid = base if top is None or (top < base and base > 0) \
                else top + 1
        self._register(tok, tid)
        return True

    def _refresh(self):
        """The added-token matchers: leftmost-longest, raw-text tokens and
        normalized-text tokens apart."""
        raw, norm = [], []
        for content, tid in self._added.items():
            if True in self._matched_as[content]:
                pat = (self._normalize(content) if self._normalize
                       else content)
                if pat:
                    norm.append((pat, tid))
            if False in self._matched_as[content]:
                raw.append((content, tid))
        self._matchers = []
        for entries in (raw, norm):
            entries.sort(key=lambda e: -len(e[0]))
            by_text = {}
            for text, tid in entries:
                by_text.setdefault(text, tid)
            regex = (re.compile("|".join(re.escape(t) for t, _ in entries))
                     if entries else None)
            self._matchers.append((regex, by_text))

    def _build_post_processor(self, spec, cls: str, config):
        """(prefix ids, suffix ids) around a single sequence."""
        if cls in _BOS_EOS_CLASSES:
            add_bos, add_eos = _BOS_EOS_CLASSES[cls]
            add_bos = config.get("add_bos_token", add_bos)
            add_eos = config.get("add_eos_token", add_eos)
            pre = [self.bos_token_id] if add_bos else []
            post = [self.eos_token_id] if add_eos else []
            if None in pre + post:
                raise ValueError(f"{cls}: add_bos_token / add_eos_token "
                                 "without the token")
            return pre, post
        return self._template(spec)

    def _template(self, spec) -> Tuple[List[int], List[int]]:
        if spec is None:
            return [], []
        kind = spec["type"]
        if kind == "ByteLevel":
            return [], []
        if kind == "Sequence":
            pre, post = [], []
            for s in spec["processors"]:
                a, b = self._template(s)
                pre, post = pre + a, b + post
            return pre, post
        if kind == "TemplateProcessing":
            pre, post, seen = [], [], False
            for piece in spec["single"]:
                if "Sequence" in piece:
                    seen = True
                    continue
                ids = spec["special_tokens"][piece["SpecialToken"]["id"]][
                    "ids"]
                (post if seen else pre).extend(int(i) for i in ids)
            return pre, post
        raise NotImplementedError(f"post-processor {kind!r}")

    # -- encoding ------------------------------------------------------

    @staticmethod
    def _find_added(text: str, regex, by_text):
        """tokenizers' AddedVocabulary.find_matches: (token id or None,
        start, end) covering `text`."""
        if regex is None or not text:
            return [(None, 0, len(text))]
        out, offset = [], 0
        for m in regex.finditer(text):
            start, stop = m.span()
            tid = by_text[m.group(0)]
            if offset < start:
                out.append((None, offset, start))
            out.append((tid, start, stop))
            offset = stop
        if offset != len(text):
            out.append((None, offset, len(text)))
        return out

    def _pieces(self, text: str):
        """(text, at_start) pieces and added-token ids, in order."""
        (raw_re, raw_map), (norm_re, norm_map) = self._matchers
        out = []
        for tid, s, e in self._find_added(text, raw_re, raw_map):
            if tid is not None:
                out.append(tid)
                continue
            piece = text[s:e]
            if self._normalize is not None:
                piece = self._normalize(piece)
            for tid2, s2, e2 in self._find_added(piece, norm_re, norm_map):
                if tid2 is not None:
                    out.append(tid2)
                elif e2 > s2:
                    out.append((piece[s2:e2], s == 0 and s2 == 0))
        return out

    def _word_ids(self, word: str) -> List[int]:
        ids = self._cache.get(word)
        if ids is None:
            ids = self._bpe(word)
            if len(self._cache) < 1 << 16:
                self._cache[word] = ids
        return ids

    def _bpe(self, word: str) -> List[int]:
        vocab = self._vocab
        if not word:
            return []
        if self._ignore_merges and word in vocab:
            return [vocab[word]]
        syms: List[int] = []
        unk = None  # a pending unknown (fuse_unk)
        unk_id = vocab.get(self._unk) if self._unk is not None else None
        for s in word:
            tid = vocab.get(s)
            if tid is not None:
                if unk is not None:
                    syms.append(unk)
                    unk = None
                syms.append(tid)
                continue
            if self._byte_fallback:
                fb = [vocab.get(f"<0x{b:02X}>") for b in s.encode("utf-8")]
                if None not in fb:
                    syms.extend(fb)
                    continue
            if unk_id is not None:
                if unk is not None and not self._fuse_unk:
                    syms.append(unk)
                unk = unk_id
        if unk is not None:
            syms.append(unk)
        return self._merge(syms)

    def _merge(self, ids: List[int]) -> List[int]:
        """Merge adjacent pairs by rank, the leftmost first among equal
        ranks (tokenizers' Word::merge_all without dropout)."""
        n = len(ids)
        if n < 2:
            return ids
        merges = self._merges
        ids = list(ids)
        nxt = list(range(1, n + 1))
        nxt[-1] = -1
        prv = list(range(-1, n - 1))
        alive = [True] * n
        heap = []
        for i in range(n - 1):
            m = merges.get((ids[i], ids[i + 1]))
            if m is not None:
                heap.append((m[0], i, m[1]))
        heapq.heapify(heap)
        while heap:
            _, pos, new_id = heapq.heappop(heap)
            if not alive[pos]:
                continue
            j = nxt[pos]
            if j == -1:
                continue
            m = merges.get((ids[pos], ids[j]))
            if m is None or m[1] != new_id:
                continue
            ids[pos] = new_id
            alive[j] = False
            nxt[pos] = nxt[j]
            if nxt[j] != -1:
                prv[nxt[j]] = pos
            p = prv[pos]
            if p != -1:
                m = merges.get((ids[p], ids[pos]))
                if m is not None:
                    heapq.heappush(heap, (m[0], p, m[1]))
            q = nxt[pos]
            if q != -1:
                m = merges.get((ids[pos], ids[q]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [t for t, a in zip(ids, alive) if a]

    def encode(self, text: str, add_special_tokens: bool = True
               ) -> List[int]:
        ids: List[int] = []
        for piece in self._pieces(text):
            if isinstance(piece, int):
                ids.append(piece)
                continue
            for word, _ in self._pre_tokenize([piece]):
                ids.extend(self._word_ids(word))
        if add_special_tokens:
            pre, post = self._post
            ids = pre + ids + post
        return ids

    def __call__(self, text: str, add_special_tokens: bool = True):
        if not isinstance(text, str):
            raise TypeError("Tokenizer: one string at a time")
        return _Encoding(self.encode(text, add_special_tokens))

    # -- decoding ------------------------------------------------------

    def decode(self, ids: Iterable, skip_special_tokens: bool = False,
               clean_up_tokenization_spaces: Optional[bool] = None) -> str:
        if hasattr(ids, "tolist"):
            ids = ids.tolist()
        if isinstance(ids, int):
            ids = [ids]
        tokens = []
        for i in ids:
            tok = self.convert_ids_to_tokens(int(i))
            if tok is None or (skip_special_tokens and tok in self._special):
                continue
            tokens.append(tok)
        if self._decoder is None:
            text = " ".join(tokens)
        else:
            text = "".join(self._decoder(tokens))
        clean = (self.clean_up_tokenization_spaces
                 if clean_up_tokenization_spaces is None
                 else clean_up_tokenization_spaces)
        return clean_up_tokenization(text) if clean else text

    # -- vocabulary ----------------------------------------------------

    def convert_ids_to_tokens(self, i):
        if isinstance(i, (list, tuple)):
            return [self.convert_ids_to_tokens(x) for x in i]
        tok = self._added_by_id.get(int(i))
        if tok is not None:
            return tok["content"]
        return self._id_to_token.get(int(i))

    def convert_tokens_to_ids(self, tokens):
        """An id per token; an unknown token maps to the unk id (None
        without one), as transformers."""
        if not isinstance(tokens, str):
            return [self.convert_tokens_to_ids(t) for t in tokens]
        tid = self._added.get(tokens, self._vocab.get(tokens))
        return self.unk_token_id if tid is None else tid

    def add_tokens(self, new_tokens, special_tokens: bool = False) -> int:
        """Add tokens (strings) to the vocabulary; returns how many were
        new. Special tokens match on the raw text and are skipped by
        `decode(skip_special_tokens=True)`."""
        if isinstance(new_tokens, str):
            new_tokens = [new_tokens]
        n = sum(self._add(_token_content(t), special_tokens)
                for t in new_tokens)
        self._refresh()
        return n

    def get_vocab(self) -> Dict[str, int]:
        return {**self._vocab, **self._added}

    def __len__(self) -> int:
        """Distinct tokens, the added ones included (transformers'
        `len(tokenizer)`)."""
        return len(self.get_vocab())

    @property
    def vocab_size(self) -> int:
        return len(self._vocab)

    def _id_of(self, key: str) -> Optional[int]:
        tok = self._tokens.get(key)
        return None if tok is None else self.convert_tokens_to_ids(tok)

    @property
    def bos_token_id(self) -> Optional[int]:
        return self._id_of("bos_token")

    @property
    def eos_token_id(self) -> Optional[int]:
        return self._id_of("eos_token")

    @property
    def pad_token_id(self) -> Optional[int]:
        return self._id_of("pad_token")

    @property
    def unk_token_id(self) -> Optional[int]:
        tok = self._tokens.get("unk_token")
        if tok is None:
            return None
        return self._added.get(tok, self._vocab.get(tok))

