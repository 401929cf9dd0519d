"""Self-contained CLIP BPE tokenizer (host-side text processing; counterpart
of ``blobctrl_tpu/tokenizer/clip_bpe.py``).

Implements the CLIP text tokenization used by SD-1.5's prompt encoder:
byte-level BPE with word-final "</w>" markers, lowercasing + whitespace
cleanup, the CLIP token regex, BOS/EOS framing, and padding/truncation to 77
tokens. Loads the standard vocab.json + merges.txt shipped with every SD-1.5
checkpoint (models/stable-diffusion-v1-5/tokenizer/).
"""

from __future__ import annotations

import functools
import html
import json
import os
import re
import unicodedata
from typing import Dict, List, Sequence, Tuple

import numpy as np

from blobctrl_torch.tokenizer import unicode_classes


def _class(table: str) -> str:
    """A ``re`` character class body of a ``unicode_classes`` table."""
    out = []
    for item in table.split():
        lo, _, hi = item.partition("-")
        out.append(re.escape(chr(int(lo, 16))) + (
            "-" + re.escape(chr(int(hi, 16))) if hi else ""))
    return "".join(out)


@functools.lru_cache()
def _classes() -> Tuple[str, str, str, str]:
    """(letter, number, space, unmatched) class bodies."""
    return tuple(_class(getattr(unicode_classes, n)) for n in (
        "LETTER", "NUMBER", "SPACE", "UNMATCHED"))


@functools.lru_cache()
def token_pattern() -> "re.Pattern":
    """CLIP's token pattern as the JAX package's tokenizer matches it. The
    JAX package writes ``[\\p{L}]+|[\\p{N}]|[^\\s\\p{L}\\p{N}]+`` for the
    ``regex`` module with IGNORECASE; the standard ``re`` has no such
    classes, and its own Unicode database and case folding differ, so the
    three classes are spelled out from the code points ``regex`` matches
    (``unicode_classes``) and only the literal alternatives are matched
    without regard to case."""
    letters, numbers, space, unmatched = _classes()
    return re.compile(
        r"(?i:<\|startoftext\|>|<\|endoftext\|>|'s|'t|'re|'ve|'m|'ll|'d)|"
        f"[{letters}]+|[{numbers}]|[^{space}{letters}{numbers}{unmatched}]+")


@functools.lru_cache()
def _space() -> "re.Pattern":
    """``regex``'s ``\\s`` (which leaves out U+001C-U+001F, where ``re``'s
    takes them)."""
    return re.compile(f"[{_classes()[2]}]+")


@functools.lru_cache()
def bytes_to_unicode() -> Dict[int, str]:
    bs = (list(range(ord("!"), ord("~") + 1))
          + list(range(ord("\xa1"), ord("\xac") + 1))
          + list(range(ord("\xae"), ord("\xff") + 1)))
    cs = bs[:]
    n = 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, [chr(c) for c in cs]))


def get_pairs(word: Tuple[str, ...]):
    return {(word[i], word[i + 1]) for i in range(len(word) - 1)}


def whitespace_clean(text: str) -> str:
    return _space().sub(" ", text).strip()


class CLIPTokenizer:
    def __init__(self, vocab: Dict[str, int], merges: List[Tuple[str, str]],
                 max_length: int = 77):
        self.encoder = vocab
        self.bpe_ranks = dict(zip(merges, range(len(merges))))
        self.byte_encoder = bytes_to_unicode()
        self.max_length = max_length
        self.bos = vocab["<|startoftext|>"]
        self.eos = vocab["<|endoftext|>"]
        self.cache = {"<|startoftext|>": "<|startoftext|>",
                      "<|endoftext|>": "<|endoftext|>"}

    @classmethod
    def from_dir(cls, tokenizer_dir: str, max_length: int = 77):
        with open(os.path.join(tokenizer_dir, "vocab.json"), encoding="utf-8") as f:
            vocab = json.load(f)
        with open(os.path.join(tokenizer_dir, "merges.txt"), encoding="utf-8") as f:
            lines = f.read().split("\n")
        merges = [tuple(l.split()) for l in lines
                  if l and not l.startswith("#version") and len(l.split()) == 2]
        return cls(vocab, merges, max_length)

    def bpe(self, token: str) -> str:
        if token in self.cache:
            return self.cache[token]
        word = tuple(token[:-1]) + (token[-1] + "</w>",)
        pairs = get_pairs(word)
        if not pairs:
            return token + "</w>"
        while True:
            bigram = min(pairs, key=lambda p: self.bpe_ranks.get(p, float("inf")))
            if bigram not in self.bpe_ranks:
                break
            first, second = bigram
            new_word: List[str] = []
            i = 0
            while i < len(word):
                try:
                    j = word.index(first, i)
                except ValueError:
                    new_word.extend(word[i:])
                    break
                new_word.extend(word[i:j])
                i = j
                if i < len(word) - 1 and word[i] == first and word[i + 1] == second:
                    new_word.append(first + second)
                    i += 2
                else:
                    new_word.append(word[i])
                    i += 1
            word = tuple(new_word)
            if len(word) == 1:
                break
            pairs = get_pairs(word)
        out = " ".join(word)
        self.cache[token] = out
        return out

    def encode(self, text: str) -> List[int]:
        # transformers' CLIPTokenizer applies ftfy.fix_text before the double
        # unescape; the port does not use ftfy and normalizes to NFC, as the
        # JAX package does without it (ASCII prompts are unaffected)
        text = unicodedata.normalize("NFC", text)
        text = whitespace_clean(html.unescape(html.unescape(text))).lower()
        ids: List[int] = []
        for token in token_pattern().findall(text):
            token = "".join(self.byte_encoder[b] for b in token.encode("utf-8"))
            ids.extend(self.encoder[t] for t in self.bpe(token).split(" "))
        return ids

    def __call__(self, texts: Sequence[str]) -> np.ndarray:
        """Batch encode -> (B, max_length) int32, BOS...EOS + EOS padding
        (matching transformers CLIPTokenizer(padding='max_length',
        truncation=True) as the SD pipelines call it)."""
        out = np.full((len(texts), self.max_length), self.eos, np.int32)
        for i, text in enumerate(texts):
            ids = [self.bos] + self.encode(text)[: self.max_length - 2] + [self.eos]
            out[i, :len(ids)] = ids
        return out
