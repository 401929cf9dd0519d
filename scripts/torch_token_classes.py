"""Writes ``blobctrl_torch/tokenizer/unicode_classes.py``: the code points
that the JAX package's CLIP token pattern (``blobctrl_tpu/tokenizer/
clip_bpe.py``, compiled by the ``regex`` module with IGNORECASE) puts in
its letter class ``[\\p{L}]``, its number class ``[\\p{N}]`` and neither,
and those ``regex``'s ``\\s`` matches, as ranges. The port builds its
pattern for the standard ``re`` from them and needs no ``regex``.

Every code point falls in exactly one of letter, number, space and the
pattern's third class ``[^\\s\\p{L}\\p{N}]``, but for the few that IGNORECASE
keeps out of all three (U+0345, whose case fold is a letter); the script
checks that partition and writes those as ``UNMATCHED``.

    python scripts/torch_token_classes.py
"""

import os
import sys

import regex

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "blobctrl_torch", "tokenizer", "unicode_classes.py")


def ranges(flags):
    out, start = [], None
    for cp, on in enumerate(flags + [False]):
        if on and start is None:
            start = cp
        elif not on and start is not None:
            out.append(f"{start:x}" if cp - 1 == start
                       else f"{start:x}-{cp - 1:x}")
            start = None
    return out


def wrapped(name, items):
    lines, line = [], ""
    for it in items:
        if len(line) + len(it) + 1 > 72:
            lines.append(line)
            line = ""
        line += ("" if not line else " ") + it
    lines.append(line)
    body = "\n".join(f'    "{s} "' for s in lines[:-1])
    body += ("\n" if body else "") + f'    "{lines[-1]}"'
    return f"{name} = (\n{body})\n"


def main():
    ic = regex.IGNORECASE
    pats = {"LETTER": regex.compile(r"[\p{L}]", ic),
            "NUMBER": regex.compile(r"[\p{N}]", ic),
            "OTHER": regex.compile(r"[^\s\p{L}\p{N}]", ic),
            "SPACE": regex.compile(r"\s")}
    flags = {k: [] for k in pats}
    for cp in range(sys.maxunicode + 1):
        c = chr(cp)
        for k, p in pats.items():
            flags[k].append(p.fullmatch(c) is not None)
    unmatched = []
    for cp in range(sys.maxunicode + 1):
        hits = sum(flags[k][cp] for k in pats)
        assert hits <= 1, hex(cp)
        if hits == 0:
            unmatched.append(cp)
    text = [
        'r"""The classes of the CLIP token pattern as the JAX package\'s',
        "tokenizer matches them: ``regex`` " + regex.__version__
        + " with IGNORECASE, its",
        "``[\\p{L}]`` (``LETTER``) and ``[\\p{N}]`` (``NUMBER``), ``\\s``"
        " (``SPACE``),",
        "and the code points that none of the pattern's three classes"
        " matches",
        "(``UNMATCHED``); every other code point is in"
        " ``[^\\s\\p{L}\\p{N}]``. Space-",
        "separated hexadecimal code points and ranges. Written by",
        '``scripts/torch_token_classes.py``; do not edit."""',
        "",
    ]
    body = "\n".join(text) + "\n"
    body += wrapped("LETTER", ranges(flags["LETTER"])) + "\n"
    body += wrapped("NUMBER", ranges(flags["NUMBER"])) + "\n"
    body += wrapped("SPACE", ranges(flags["SPACE"])) + "\n"
    body += wrapped("UNMATCHED", [f"{cp:x}" for cp in unmatched])
    with open(OUT, "w") as f:
        f.write(body)
    print(OUT, {k: sum(v) for k, v in flags.items()},
          "unmatched", [hex(c) for c in unmatched])


if __name__ == "__main__":
    main()
