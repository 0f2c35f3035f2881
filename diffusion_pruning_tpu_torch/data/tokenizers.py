"""Tokenizer builders with the hash fallback the entry points share.

A real run reads the tokenizer files of local checkpoint folders: CLIP's
byte-level BPE (`{sd_root}/tokenizer/vocab.json` and `merges.txt`) and
MPNet's WordPiece (`{root}/vocab.txt`), each with the special tokens of the
folder's `special_tokens_map.json` and `tokenizer_config.json`. The JAX
package loads the same files through `transformers` (`CLIPTokenizer`,
`AutoTokenizer`); this module is its own reader of them and gives the same
ids and masks:

- CLIP as `transformers.CLIPTokenizer` runs without `ftfy`: the text is
  cleaned, split around CJK characters, NFC-normalised and lower-cased
  (`BasicTokenizer(strip_accents=False, do_split_on_punc=False)`), split by
  CLIP's pattern, mapped to byte-level unicode and merged by BPE rank;
  `[bos] + tokens[:max_length - 2] + [eos]`, padded with the folder's pad
  token (SD-2.1 pads with `"!"`, id 0).
- MPNet as `transformers.MPNetTokenizer`: lower-cased with accents
  stripped, CJK split, split on punctuation, greedy longest-match WordPiece
  with `##` continuations and at most 100 characters a word;
  `<s> … </s>`, `<pad>` padding and an attention mask.

Special tokens are split out of the text first, leftmost and longest, as
`transformers`' added-token trie does. The stdlib `re` has no `\\p{L}` or
`\\p{N}`, so those classes are built from `unicodedata`.

Without the folders every entry point falls back to the deterministic hash
tokenizer (`dummy_tokenizer.py`), so the whole control flow, the on-disk
dataset path included, runs without downloaded checkpoints.
"""
from __future__ import annotations

import functools
import json
import os
import re
import sys
import unicodedata
from typing import Dict, List, Optional, Tuple

import numpy as np

from .dummy_tokenizer import DummyTokenizer

# CLIP's transformers reader keeps the first 49152 - 256 - 2 merges
CLIP_MAX_MERGES = 49152 - 256 - 2
WORDPIECE_MAX_CHARS = 100
SPECIAL_ATTRS = ("bos_token", "eos_token", "unk_token", "sep_token", "pad_token", "cls_token",
                 "mask_token")


class Encoding(dict):
    """`input_ids` and `attention_mask` by key and by attribute, as a
    `transformers.BatchEncoding` gives them."""

    @property
    def input_ids(self) -> np.ndarray:
        return self["input_ids"]

    @property
    def attention_mask(self) -> np.ndarray:
        return self["attention_mask"]


# ---------------------------------------------------------------- text cleaning

def _is_whitespace(ch: str) -> bool:
    return ch in " \t\n\r" or unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    return ch not in "\t\n\r" and unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if 33 <= cp <= 47 or 58 <= cp <= 64 or 91 <= cp <= 96 or 123 <= cp <= 126:
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF or 0x20000 <= cp <= 0x2A6DF
            or 0x2A700 <= cp <= 0x2B73F or 0x2B740 <= cp <= 0x2B81F
            or 0x2B820 <= cp <= 0x2CEAF or 0xF900 <= cp <= 0xFAFF
            or 0x2F800 <= cp <= 0x2FA1F)


def _strip_accents(text: str) -> str:
    return "".join(c for c in unicodedata.normalize("NFD", text)
                   if unicodedata.category(c) != "Mn")


def _split_on_punctuation(word: str) -> List[str]:
    out: List[List[str]] = []
    start_new = True
    for ch in word:
        if _is_punctuation(ch):
            out.append([ch])
            start_new = True
        else:
            if start_new:
                out.append([])
            start_new = False
            out[-1].append(ch)
    return ["".join(x) for x in out]


def basic_tokenize(text: str, lower: bool = True, strip_accents: Optional[bool] = None,
                   split_punctuation: bool = True, chinese_chars: bool = True,
                   never_split: frozenset = frozenset()) -> List[str]:
    """`transformers`' `BasicTokenizer.tokenize`: drop control characters and
    U+0000/U+FFFD, map whitespace to spaces, space out CJK characters, NFC,
    split on whitespace, lower-case (and strip accents unless
    `strip_accents` is False; with `lower` off, only when it is True), split
    off punctuation; a word in `never_split` is kept as it is."""
    chars = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_whitespace(ch):
            chars.append(" ")
        elif chinese_chars and _is_cjk(cp):
            chars.append(f" {ch} ")
        else:
            chars.append(ch)
    out: List[str] = []
    for token in unicodedata.normalize("NFC", "".join(chars)).split():
        if token in never_split:
            out.append(token)
            continue
        if lower:
            token = token.lower()
            if strip_accents is not False:
                token = _strip_accents(token)
        elif strip_accents:
            token = _strip_accents(token)
        out.extend(_split_on_punctuation(token) if split_punctuation else [token])
    return " ".join(out).split()


# ---------------------------------------------------------------- special tokens

def _token_content(value) -> Tuple[Optional[str], bool, bool]:
    """(content, lstrip, rstrip) of a special-token entry (a string or an
    AddedToken dict)."""
    if isinstance(value, dict):
        return value.get("content"), bool(value.get("lstrip")), bool(value.get("rstrip"))
    return value, False, False


def read_json(folder: str, name: str) -> dict:
    """A tokenizer folder's JSON file, or {} where it has none."""
    path = os.path.join(folder, name)
    if not os.path.exists(path):
        return {}
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def read_special_tokens(folder: str, defaults: Dict[str, object]) -> Dict[str, Tuple[str, bool,
                                                                                     bool]]:
    """The special tokens of a tokenizer folder: `defaults`, overridden by
    `tokenizer_config.json`, overridden by `special_tokens_map.json` (the
    order `from_pretrained` applies them)."""
    tokens = {k: _token_content(v) for k, v in defaults.items()}
    for name in ("tokenizer_config.json", "special_tokens_map.json"):
        data = read_json(folder, name)
        for attr in SPECIAL_ATTRS:
            if data.get(attr) is not None:
                tokens[attr] = _token_content(data[attr])
    return {k: v for k, v in tokens.items() if v[0] is not None}


class _Tokenizer:
    """What both tokenizers share: the special-token split, ids, truncation,
    padding and the call signature of the JAX package's callers. Subclasses
    set `vocab`, `specials` and `model_max_length` and define `_tokenize`."""
    vocab: Dict[str, int]
    specials: Dict[str, Tuple[str, bool, bool]]
    model_max_length: int

    def _init_specials(self) -> None:
        # special tokens missing from the vocabulary take the ids after it,
        # in the order transformers adds them
        self.added: Dict[str, int] = {}
        for attr in SPECIAL_ATTRS:
            content = self.specials.get(attr, (None,))[0]
            if content is not None and content not in self.vocab and content not in self.added:
                self.added[content] = len(self.vocab) + len(self.added)
        self.special_strip = {c: (l, r) for c, l, r in self.specials.values()}
        self.special_by_length = sorted(self.special_strip, key=len, reverse=True)

    def token_id(self, token: str) -> int:
        if token in self.added:
            return self.added[token]
        return self.vocab.get(token, self.vocab.get(self.specials["unk_token"][0], 0))

    def special_id(self, attr: str) -> int:
        return self.token_id(self.specials[attr][0])

    def _split_special(self, text: str) -> List[str]:
        """Split out special tokens, leftmost and longest first, and strip
        the whitespace an `lstrip`/`rstrip` token takes from its neighbours."""
        pieces: List[str] = []
        start = i = 0
        while i < len(text):
            hit = next((s for s in self.special_by_length if text.startswith(s, i)), None)
            if hit is None:
                i += 1
                continue
            pieces += [text[start:i], hit]
            i = start = i + len(hit)
        pieces.append(text[start:])
        for j, piece in enumerate(pieces):
            if j % 2 == 1:
                lstrip, rstrip = self.special_strip[piece]
                if lstrip:
                    pieces[j - 1] = pieces[j - 1].rstrip()
                if rstrip:
                    pieces[j + 1] = pieces[j + 1].lstrip()
        return pieces

    def _prepare(self, text: str) -> str:
        return text

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for j, piece in enumerate(self._split_special(self._prepare(str(text)))):
            if j % 2 == 1:
                out.append(piece)
            elif piece:
                out.extend(self._tokenize(piece))
        return out

    def encode(self, text: str) -> List[int]:
        """Token ids of `text`, no special tokens around them."""
        return [self.token_id(t) for t in self.tokenize(text)]

    def __call__(self, texts, max_length: Optional[int] = None, padding="max_length",
                 truncation=True, return_tensors="np") -> Encoding:
        """(B, max_length) int64 ids and attention mask of `texts`:
        `[bos] + tokens[:max_length - 2] + [eos]`, then the pad token. The
        JAX package's callers' arguments; other paddings, no truncation and
        other tensor types are refused."""
        if (padding, bool(truncation), return_tensors) != ("max_length", True, "np"):
            raise ValueError("only padding='max_length', truncation=True and "
                             "return_tensors='np' are supported")
        if isinstance(texts, str):
            texts = [texts]
        max_length = max_length or self.model_max_length
        bos, eos = self.special_id(self.bos_attr), self.special_id(self.eos_attr)
        input_ids = np.full((len(texts), max_length), self.special_id("pad_token"), np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, text in enumerate(texts):
            row = [bos, *self.encode(text)[:max(max_length - 2, 0)], eos]
            input_ids[i, :len(row)] = row
            mask[i, :len(row)] = 1
        return Encoding(input_ids=input_ids, attention_mask=mask)


# ---------------------------------------------------------------- CLIP BPE

@functools.lru_cache(maxsize=None)
def bytes_to_unicode() -> Dict[int, str]:
    """GPT-2's reversible map of the 256 bytes to printable characters."""
    bs = (list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1))
          + list(range(ord("®"), ord("ÿ") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, (chr(c) for c in cs)))


def _class_ranges(prefix: str) -> str:
    """A regex character class body of every code point whose Unicode
    category starts with `prefix` (L: letters, N: numbers)."""
    parts = []
    start = prev = None
    for cp in range(0x110000):
        if unicodedata.category(chr(cp)).startswith(prefix):
            if start is None:
                start = cp
            elif cp != prev + 1:
                parts.append((start, prev))
                start = cp
            prev = cp
    parts.append((start, prev))
    return "".join(re.escape(chr(a)) if a == b else f"{re.escape(chr(a))}-{re.escape(chr(b))}"
                   for a, b in parts)


@functools.lru_cache(maxsize=None)
def clip_pattern() -> "re.Pattern[str]":
    """CLIP's split pattern `<\\|startoftext\\|>|<\\|endoftext\\|>|'s|'t|'re|'ve|'m|'ll|'d|
    [\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+` (case-insensitive) in the stdlib
    `re`, its classes from `unicodedata` (built once, about half a second)."""
    letters, numbers = _class_ranges("L"), _class_ranges("N")
    return re.compile(rf"<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d"
                      rf"|[{letters}]+|[{numbers}]|[^\s{letters}{numbers}]+", re.IGNORECASE)


# U+0345 (combining ypogegrammeni) case-folds to a letter: the `regex`
# package's case-insensitive classes then match it nowhere, so it only
# separates the matches around it
_CLIP_SEPARATORS = {0x345: " "}


class CLIPTokenizer(_Tokenizer):
    """CLIP's byte-level BPE from `vocab.json` and `merges.txt` of `folder`."""
    bos_attr, eos_attr = "bos_token", "eos_token"

    def __init__(self, folder: str):
        with open(os.path.join(folder, "vocab.json"), encoding="utf-8") as f:
            self.vocab = json.load(f)
        with open(os.path.join(folder, "merges.txt"), encoding="utf-8") as f:
            # the first line is the "#version" header
            merges = f.read().strip().split("\n")[1:CLIP_MAX_MERGES + 1]
        self.ranks = {tuple(m.split()): i for i, m in enumerate(merges)}
        self.specials = read_special_tokens(folder, {
            "bos_token": "<|startoftext|>", "eos_token": "<|endoftext|>",
            "unk_token": "<|endoftext|>", "pad_token": "<|endoftext|>"})
        self.model_max_length = int(read_json(folder, "tokenizer_config.json").get(
            "model_max_length", 77))
        self.byte_encoder = bytes_to_unicode()
        self.pattern = clip_pattern()
        self.cache = {"<|startoftext|>": "<|startoftext|>", "<|endoftext|>": "<|endoftext|>"}
        self._init_specials()

    def bpe(self, token: str) -> str:
        """The merged pieces of one byte-mapped word, space-separated
        (cached by word)."""
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        while len(word) > 1:
            pairs = set(zip(word, word[1:]))
            best = min(pairs, key=lambda p: self.ranks.get(p, float("inf")))
            if best not in self.ranks:
                break
            first, second = best
            merged: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    merged.extend(word[i:])
                    break
                merged.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i + 1] == second:
                    merged.append(first + second)
                    i += 2
                else:
                    merged.append(word[i])
                    i += 1
            word = tuple(merged)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def _tokenize(self, text: str) -> List[str]:
        text = " ".join(basic_tokenize(text, lower=True, strip_accents=False,
                                       split_punctuation=False))
        text = text.translate(_CLIP_SEPARATORS)
        out: List[str] = []
        for token in self.pattern.findall(text):
            mapped = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            out.extend(self.bpe(mapped).split(" "))
        return out


# ---------------------------------------------------------------- MPNet WordPiece

class MPNetTokenizer(_Tokenizer):
    """MPNet's WordPiece from `vocab.txt` of `folder`."""
    bos_attr, eos_attr = "cls_token", "sep_token"

    def __init__(self, folder: str):
        with open(os.path.join(folder, "vocab.txt"), encoding="utf-8") as f:
            self.vocab = {}
            for i, line in enumerate(f):
                self.vocab[line.rstrip("\n")] = i  # a repeated token keeps its last id
        self.specials = read_special_tokens(folder, {
            "bos_token": "<s>", "eos_token": "</s>", "sep_token": "</s>", "cls_token": "<s>",
            "unk_token": "[UNK]", "pad_token": "<pad>",
            "mask_token": {"content": "<mask>", "lstrip": True}})
        cfg = read_json(folder, "tokenizer_config.json")
        self.lower = bool(cfg.get("do_lower_case", True))
        self.strip_accents = cfg.get("strip_accents")
        self.chinese_chars = bool(cfg.get("tokenize_chinese_chars", True))
        self.model_max_length = int(cfg.get("model_max_length", 512))
        self._init_specials()
        self.unk = self.specials["unk_token"][0]

    def _prepare(self, text: str) -> str:
        # lower-case all but the special tokens (and newlines, which stay)
        if not self.lower:
            return text
        alts = "|".join(re.escape(s) for s in self.special_strip)
        return re.sub(rf"({alts})|(.+?)", lambda m: m.group(1) or m.group(2).lower(), text)

    def wordpiece(self, word: str) -> List[str]:
        if len(word) > WORDPIECE_MAX_CHARS:
            return [self.unk]
        pieces, start = [], 0
        while start < len(word):
            end = len(word)
            while start < end:
                piece = word[start:end] if start == 0 else "##" + word[start:end]
                if piece in self.vocab:
                    break
                end -= 1
            else:
                return [self.unk]
            pieces.append(piece)
            start = end
        return pieces

    def _tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in basic_tokenize(text, lower=self.lower, strip_accents=self.strip_accents,
                                   chinese_chars=self.chinese_chars,
                                   never_split=frozenset(self.special_strip)):
            out.extend(self.wordpiece(word))
        return out


# ---------------------------------------------------------------- builders

def build_clip_tokenizer(sd_root, max_length: int = 77, vocab_size: int = 128):
    """CLIP's BPE from `{sd_root}/tokenizer`, or the hash fallback."""
    path = os.path.join(sd_root or "", "tokenizer")
    if os.path.exists(path):
        return CLIPTokenizer(path)
    print(f"[smoke] CLIP tokenizer {path!r} missing — dummy hash tokenizer", file=sys.stderr)
    return DummyTokenizer(vocab_size=vocab_size, max_length=max_length)


def build_mpnet_tokenizer(root, vocab_size: int, max_length: int = 128):
    """MPNet's WordPiece from the MPNet folder, or the hash fallback sized to
    the model's vocabulary."""
    if root and os.path.exists(root):
        return MPNetTokenizer(root)
    print(f"[smoke] MPNet tokenizer {root!r} missing — dummy hash tokenizer", file=sys.stderr)
    return DummyTokenizer(vocab_size=vocab_size, max_length=max_length)

