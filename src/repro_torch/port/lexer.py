"""C tokenizer for the NEON-kernel subset the port frontend accepts.

Nothing clever: a hand-rolled scanner producing (kind, text, line, col)
tokens, skipping comments and preprocessor lines.  The paper's migration
object is real intrinsic source (XNNPACK microkernels, SIMDe test
bodies), which is plain C99 — identifiers, numeric literals, and a small
fixed set of multi-character operators cover the whole corpus.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, List

from .resilience import ParseError

__all__ = ["Token", "tokenize", "LexError"]


class LexError(ParseError):
    """Tokenizer rejection; a ParseError (and so a SyntaxError)."""


@dataclasses.dataclass(frozen=True)
class Token:
    kind: str            # 'ident' | 'num' | 'punct' | 'eof'
    text: str
    line: int
    col: int

    def __repr__(self):
        return f"Token({self.kind}, {self.text!r}, {self.line}:{self.col})"


# Longest-match-first operator/punctuation set (the subset grammar's).
_PUNCTS = (
    "<<=", ">>=", "->", "++", "--", "+=", "-=", "*=", "/=", "%=", "&=",
    "|=", "^=", "<<", ">>", "<=", ">=", "==", "!=", "&&", "||",
    "+", "-", "*", "/", "%", "=", "<", ">", "!", "~", "&", "|", "^",
    "(", ")", "{", "}", "[", "]", ";", ",", "?", ":", ".",
)

_IDENT_START = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ_")
_IDENT_CONT = _IDENT_START | set("0123456789")
_DIGITS = set("0123456789")


def tokenize(source: str) -> List[Token]:
    return list(_scan(source))


def _scan(src: str) -> Iterator[Token]:
    i, n = 0, len(src)
    line, col = 1, 1

    def bump(k: int):
        nonlocal i, line, col
        for _ in range(k):
            if i < n and src[i] == "\n":
                line += 1
                col = 1
            else:
                col += 1
            i += 1

    while i < n:
        c = src[i]
        # whitespace
        if c in " \t\r\n":
            bump(1)
            continue
        # preprocessor line: skip to end of line (no macro expansion in
        # the subset — corpus kernels carry no function-like macros)
        if c == "#" and (col == 1 or src[:i].rstrip(" \t").endswith("\n")):
            while i < n and src[i] != "\n":
                bump(1)
            continue
        # comments
        if src.startswith("//", i):
            while i < n and src[i] != "\n":
                bump(1)
            continue
        if src.startswith("/*", i):
            end = src.find("*/", i + 2)
            if end < 0:
                raise LexError("unterminated comment",
                               line=line, col=col)
            bump(end + 2 - i)
            continue
        # identifiers / keywords / intrinsic names
        if c in _IDENT_START:
            j = i
            while j < n and src[j] in _IDENT_CONT:
                j += 1
            yield Token("ident", src[i:j], line, col)
            bump(j - i)
            continue
        # numeric literals (decimal/hex ints, floats, suffixes f/u/l)
        if c in _DIGITS or (c == "." and i + 1 < n and src[i + 1] in _DIGITS):
            j = i
            if src.startswith("0x", i) or src.startswith("0X", i):
                j = i + 2
                while j < n and src[j] in "0123456789abcdefABCDEF":
                    j += 1
            else:
                while j < n and (src[j] in _DIGITS or src[j] == "."):
                    j += 1
                if j < n and src[j] in "eE":
                    j += 1
                    if j < n and src[j] in "+-":
                        j += 1
                    while j < n and src[j] in _DIGITS:
                        j += 1
            while j < n and src[j] in "fFuUlL":
                j += 1
            yield Token("num", src[i:j], line, col)
            bump(j - i)
            continue
        # operators / punctuation, longest match first
        for p in _PUNCTS:
            if src.startswith(p, i):
                yield Token("punct", p, line, col)
                bump(len(p))
                break
        else:
            raise LexError(f"unexpected character {c!r}",
                           line=line, col=col)
    yield Token("eof", "", line, col)
