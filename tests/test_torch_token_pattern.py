"""The port's CLIP token pattern and whitespace cleanup against the JAX
package's (``blobctrl_tpu/tokenizer/clip_bpe.py``, the ``regex`` module
with IGNORECASE): the same matches for every code point alone and after
an apostrophe (the literal ``'s``/``'re``... alternatives); the same
cleanup of every code point; the same matches and ids
(``test_torch_encoders.synthetic_vocab``) on 20,000 random strings; and
the cases where ``re``'s own Unicode classes and case folding split
otherwise (U+088F, U+0C5C, U+13FE7 are letters to ``regex``; U+0345
matches no class under IGNORECASE; U+001C-U+001F are not ``\\s``). About
40 s."""

import sys

import numpy as np
import pytest

from blobctrl_tpu.tokenizer import clip_bpe as jbpe
from blobctrl_torch.tokenizer import clip_bpe as tbpe
from tests.test_torch_encoders import synthetic_vocab

ALL = range(sys.maxunicode + 1)


def _differ(make):
    """The code points whose text ``make(chr(cp))`` the two patterns split
    differently."""
    got, want = tbpe.token_pattern().findall, jbpe._PAT.findall
    return [hex(cp) for cp in ALL
            if got(make(chr(cp))) != want(make(chr(cp)))]


@pytest.mark.parametrize("context", ["{}", "'{0}e'{0}l"])
def test_every_code_point_splits_as_in_jax(context):
    """Alone, and after an apostrophe before the letters of 're and 'll
    (the literal alternatives, matched without regard to case)."""
    assert _differ(context.format) == []


def test_every_code_point_is_cleaned_as_in_jax():
    bad = [hex(cp) for cp in ALL
           if tbpe.whitespace_clean(f"a{chr(cp)}b")
           != jbpe.whitespace_clean(f"a{chr(cp)}b")]
    assert bad == []


def _random_strings(n=20000, seed=0):
    """Short strings of ASCII, of the first 12,288 code points and of any
    code point, mixed."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        k = rng.randint(1, 12)
        pools = rng.randint(0, 3, k)
        cps = [int(rng.randint(0, (128, 0x3000, sys.maxunicode + 1)[p]))
               for p in pools]
        out.append("".join(map(chr, cps)))
    return out


def test_random_strings_split_and_encode_as_in_jax():
    vocab, merges = synthetic_vocab()
    jtok = jbpe.CLIPTokenizer(vocab, merges)
    ttok = tbpe.CLIPTokenizer(vocab, merges)
    texts = _random_strings()
    split = [s for s in texts
             if tbpe.token_pattern().findall(s) != jbpe._PAT.findall(s)]
    assert split == []
    # surrogates cannot be UTF-8 encoded on either side
    texts = [s for s in texts if not any(0xD800 <= ord(c) < 0xE000
                                         for c in s)]
    assert len(texts) > 19000
    for i in range(0, len(texts), 500):
        np.testing.assert_array_equal(ttok(texts[i:i + 500]),
                                      jtok(texts[i:i + 500]))


@pytest.mark.parametrize("text,tokens", [
    ("x\U00013fe7y", ["x\U00013fe7y"]),
    ("aͅb", ["a", "b"]),
    ("࢏౜ 7", ["࢏౜", "7"]),
    ("it'S a\x1cb", ["it", "'S", "a", "\x1c", "b"]),
])
def test_the_cases_res_own_classes_split_otherwise(text, tokens):
    assert jbpe._PAT.findall(text) == tokens
    assert tbpe.token_pattern().findall(text) == tokens
