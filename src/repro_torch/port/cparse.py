"""Recursive-descent parser for the practical C subset NEON kernels use.

The grammar covers what real XNNPACK-style intrinsic microkernels are
written in: function definitions over scalar/pointer/vector-register
parameters, declarations of ``vN_tM``-typed locals, assignments,
intrinsic calls, pointer arithmetic, and ``for``/``while`` strip-mine
loops over lanes and pointers.  No macros, no structs, no function
pointers — the paper's migration corpus does not need them.

The parser produces a plain AST (dataclasses below); type assignment and
SSA construction happen in :mod:`repro_torch.port.lower`.
"""
from __future__ import annotations

import dataclasses
import re
from typing import List, Optional, Tuple, Union

from .lexer import Token, tokenize
from .resilience import ParseError

__all__ = [
    "parse", "ParseError",
    "Scalar", "Ptr", "VecT", "Param", "FuncDef",
    "Block", "Decl", "If", "For", "While", "Return", "ExprStmt", "Assign",
    "Name", "Num", "Call", "Un", "Bin", "Cast", "Index", "Ternary",
    "Member",
]


# ---------------------------------------------------------------------------
# Types as spelled in source
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Scalar:
    """A C scalar type, canonicalized to a numpy dtype name ('float32',
    'uint8', ...), 'void', or 'size_t' (a lane/byte counter)."""
    name: str


@dataclasses.dataclass(frozen=True)
class Ptr:
    elem: Scalar
    const: bool = False


@dataclasses.dataclass(frozen=True)
class VecT:
    """A NEON register type by its source name (float32x4_t, ...)."""
    name: str


CType = Union[Scalar, Ptr, VecT]

_SCALAR_NAMES = {
    "float": "float32", "double": "float64",
    "int": "int32", "unsigned": "uint32", "char": "int8",
    "int8_t": "int8", "int16_t": "int16", "int32_t": "int32",
    "int64_t": "int64",
    "uint8_t": "uint8", "uint16_t": "uint16", "uint32_t": "uint32",
    "uint64_t": "uint64",
    "size_t": "size_t", "void": "void",
}

# plain registers (float32x4_t) and multi-register structs
# (float32x4x2_t .. x4 — the vld2/vld3/vld4 result types)
_VEC_RE = re.compile(r"^(u?int|float)(8|16|32|64)x(\d+)(x[234])?_t$")


def is_type_name(text: str) -> bool:
    return text in _SCALAR_NAMES or bool(_VEC_RE.match(text))


# ---------------------------------------------------------------------------
# AST
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Param:
    type: CType
    name: str


@dataclasses.dataclass
class FuncDef:
    name: str
    ret: CType
    params: List[Param]
    body: "Block"


@dataclasses.dataclass
class Block:
    stmts: List[object]


@dataclasses.dataclass
class Decl:
    type: CType
    name: str
    init: Optional[object]


@dataclasses.dataclass
class If:
    cond: object
    then: Block
    els: Optional[Block]


@dataclasses.dataclass
class For:
    init: Optional[object]       # Decl | Assign | None
    cond: Optional[object]
    step: Optional[object]       # Assign | None
    body: Block


@dataclasses.dataclass
class While:
    cond: object
    body: Block


@dataclasses.dataclass
class Return:
    value: Optional[object]


@dataclasses.dataclass
class ExprStmt:
    expr: object


@dataclasses.dataclass
class Assign:
    """``target op= value``; op '' is plain assignment.  Target is a
    Name, a pointer deref (Un('*', Name)), or an Index."""
    target: object
    op: str
    value: object


@dataclasses.dataclass
class Name:
    id: str


@dataclasses.dataclass
class Num:
    value: Union[int, float]


@dataclasses.dataclass
class Call:
    name: str
    args: List[object]
    line: int = 0                # source line (for diagnostics)


@dataclasses.dataclass
class Un:
    op: str                      # '-', '!', '~', '*' (deref)
    expr: object


@dataclasses.dataclass
class Bin:
    op: str
    lhs: object
    rhs: object


@dataclasses.dataclass
class Cast:
    type: CType
    expr: object


@dataclasses.dataclass
class Index:
    base: object
    index: object


@dataclasses.dataclass
class Member:
    """``base.field`` — only ``.val`` on NEON register structs in the
    subset, always further indexed (``x.val[0]``)."""
    base: object
    name: str
    line: int = 0                # source line (for diagnostics)


@dataclasses.dataclass
class Ternary:
    cond: object
    then: object
    els: object


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------

_ASSIGN_OPS = {"=", "+=", "-=", "*=", "/=", "%=", "&=", "|=", "^=",
               "<<=", ">>="}
# binary precedence, loosest first (no ||/&& short-circuit subtlety at
# the subset's scalar-control-flow level)
_BIN_LEVELS = [
    ["||"], ["&&"], ["|"], ["^"], ["&"],
    ["==", "!="], ["<", ">", "<=", ">="],
    ["<<", ">>"], ["+", "-"], ["*", "/", "%"],
]


def parse(source: str, filename: Optional[str] = None) -> List[FuncDef]:
    """Parse translation-unit source into its function definitions.

    Every rejection — including the tokenizer's — surfaces as a
    :class:`ParseError` carrying ``file:line:col`` provenance; a
    truncated or mutated source must never escape as a raw
    ``IndexError``/``KeyError``/``RecursionError``.
    """
    try:
        toks = tokenize(source)
        return _Parser(toks, filename=filename).program()
    except ParseError as e:
        raise e.add_context(file=filename)
    except RecursionError:
        raise ParseError("expression nesting too deep", file=filename)


class _Parser:
    def __init__(self, toks: List[Token], filename: Optional[str] = None):
        self.toks = toks
        self.pos = 0
        self.filename = filename

    # -- token plumbing -----------------------------------------------------
    def peek(self, ahead: int = 0) -> Token:
        return self.toks[min(self.pos + ahead, len(self.toks) - 1)]

    def next(self) -> Token:
        t = self.peek()
        self.pos += 1
        return t

    def at(self, kind: str, text: Optional[str] = None,
           ahead: int = 0) -> bool:
        t = self.peek(ahead)
        return t.kind == kind and (text is None or t.text == text)

    def expect(self, kind: str, text: Optional[str] = None) -> Token:
        t = self.peek()
        if not self.at(kind, text):
            want = text or kind
            got = t.text if t.kind != "eof" else "<eof>"
            raise ParseError(f"expected {want!r}, got {got!r}",
                             file=self.filename, line=t.line, col=t.col)
        return self.next()

    def accept(self, kind: str, text: Optional[str] = None) -> bool:
        if self.at(kind, text):
            self.next()
            return True
        return False

    # -- grammar ------------------------------------------------------------
    def program(self) -> List[FuncDef]:
        fns = []
        while not self.at("eof"):
            fns.append(self.funcdef())
        return fns

    def funcdef(self) -> FuncDef:
        while self.at("ident") and self.peek().text in ("static", "inline",
                                                        "extern"):
            self.next()
        ret = self.type_name()
        name = self.expect("ident").text
        self.expect("punct", "(")
        params = []
        if not self.at("punct", ")"):
            while True:
                params.append(self.param())
                if not self.accept("punct", ","):
                    break
        self.expect("punct", ")")
        body = self.block()
        return FuncDef(name=name, ret=ret, params=params, body=body)

    def type_name(self) -> CType:
        """[const] base [*] [const] — pointer declarators fold into the
        type (single-level pointers only, which is all kernels use)."""
        const = False
        if self.at("ident", "const"):
            self.next()
            const = True
        t = self.expect("ident")
        if t.text in _SCALAR_NAMES:
            base: CType = Scalar(_SCALAR_NAMES[t.text])
        elif _VEC_RE.match(t.text):
            base = VecT(t.text)
        else:
            raise ParseError(f"unknown type {t.text!r}",
                             file=self.filename, line=t.line, col=t.col)
        if self.accept("punct", "*"):
            if self.at("ident", "const"):
                self.next()
            if not isinstance(base, Scalar):
                raise ParseError(f"pointer to {t.text!r} unsupported",
                                 file=self.filename, line=t.line,
                                 col=t.col)
            return Ptr(elem=base, const=const)
        if const and isinstance(base, Scalar):
            return base        # const scalar by value: qualifier is moot
        return base

    def param(self) -> Param:
        ty = self.type_name()
        name = self.expect("ident").text
        return Param(type=ty, name=name)

    def block(self) -> Block:
        self.expect("punct", "{")
        stmts = []
        while not self.at("punct", "}"):
            stmts.append(self.statement())
        self.expect("punct", "}")
        return Block(stmts=stmts)

    def _starts_decl(self) -> bool:
        if self.at("ident", "const"):
            return True
        if not self.at("ident") or not is_type_name(self.peek().text):
            return False
        # 'float x' / 'float* x' / 'float32x4_t x' — a type name followed
        # by a declarator, not e.g. a cast inside an expression statement
        return (self.at("ident", ahead=1) or
                self.at("punct", "*", ahead=1))

    def statement(self):
        if self.at("punct", "{"):
            return self.block()
        if self.at("ident", "if"):
            return self.if_stmt()
        if self.at("ident", "for"):
            return self.for_stmt()
        if self.at("ident", "while"):
            return self.while_stmt()
        if self.at("ident", "do"):
            return self.do_stmt()
        if self.at("ident", "return"):
            self.next()
            val = None if self.at("punct", ";") else self.expression()
            self.expect("punct", ";")
            return Return(value=val)
        if self._starts_decl():
            d = self.declaration()
            self.expect("punct", ";")
            return d
        s = self.expr_or_assign()
        self.expect("punct", ";")
        return s

    def declaration(self) -> Decl:
        ty = self.type_name()
        name = self.expect("ident").text
        init = None
        if self.accept("punct", "="):
            init = self.expression()
        return Decl(type=ty, name=name, init=init)

    def if_stmt(self) -> If:
        self.expect("ident", "if")
        self.expect("punct", "(")
        cond = self.expression()
        self.expect("punct", ")")
        then = self._stmt_as_block()
        els = None
        if self.accept("ident", "else"):
            els = self._stmt_as_block()
        return If(cond=cond, then=then, els=els)

    def _stmt_as_block(self) -> Block:
        s = self.statement()
        return s if isinstance(s, Block) else Block(stmts=[s])

    def for_stmt(self) -> For:
        self.expect("ident", "for")
        self.expect("punct", "(")
        init = None
        if not self.at("punct", ";"):
            init = (self.declaration() if self._starts_decl()
                    else self.expr_or_assign())
        self.expect("punct", ";")
        cond = None if self.at("punct", ";") else self.expression()
        self.expect("punct", ";")
        step = None if self.at("punct", ")") else self.expr_or_assign()
        self.expect("punct", ")")
        body = self._stmt_as_block()
        return For(init=init, cond=cond, step=step, body=body)

    def while_stmt(self) -> While:
        self.expect("ident", "while")
        self.expect("punct", "(")
        cond = self.expression()
        self.expect("punct", ")")
        return While(cond=cond, body=self._stmt_as_block())

    def do_stmt(self):
        self.expect("ident", "do")
        body = self._stmt_as_block()
        self.expect("ident", "while")
        self.expect("punct", "(")
        cond = self.expression()
        self.expect("punct", ")")
        self.expect("punct", ";")
        # do{B}while(c) == B; while(c){B} — corpus loops have no breaks
        return Block(stmts=[body, While(cond=cond, body=body)])

    def expr_or_assign(self):
        """An expression statement, assignment, or ++/-- update."""
        if self.at("punct", "++") or self.at("punct", "--"):
            op = self.next().text
            tgt = self.unary()
            return Assign(target=tgt, op="+=" if op == "++" else "-=",
                          value=Num(1))
        e = self.expression()
        t = self.peek()
        if t.kind == "punct" and t.text in _ASSIGN_OPS:
            self.next()
            if not isinstance(e, (Name, Un, Index)) or \
                    (isinstance(e, Un) and e.op != "*"):
                raise ParseError("bad assignment target",
                                 file=self.filename, line=t.line,
                                 col=t.col)
            rhs = self.expression()
            return Assign(target=e, op="" if t.text == "=" else t.text[:-1],
                          value=rhs)
        if self.at("punct", "++") or self.at("punct", "--"):
            op = self.next().text
            return Assign(target=e, op="+=" if op == "++" else "-=",
                          value=Num(1))
        return ExprStmt(expr=e)

    # -- expressions (precedence climbing) ----------------------------------
    def expression(self):
        return self.ternary()

    def ternary(self):
        c = self.binary(0)
        if self.accept("punct", "?"):
            a = self.expression()
            self.expect("punct", ":")
            b = self.ternary()
            return Ternary(cond=c, then=a, els=b)
        return c

    def binary(self, level: int):
        if level >= len(_BIN_LEVELS):
            return self.unary()
        lhs = self.binary(level + 1)
        while self.at("punct") and self.peek().text in _BIN_LEVELS[level]:
            op = self.next().text
            rhs = self.binary(level + 1)
            lhs = Bin(op=op, lhs=lhs, rhs=rhs)
        return lhs

    def unary(self):
        t = self.peek()
        if t.kind == "punct" and t.text in ("-", "!", "~", "*", "+"):
            self.next()
            e = self.unary()
            return e if t.text == "+" else Un(op=t.text, expr=e)
        if t.kind == "punct" and t.text == "(":
            # cast vs parenthesized expression: lookahead for a type name
            nxt = self.peek(1)
            if nxt.kind == "ident" and (is_type_name(nxt.text) or
                                        nxt.text == "const"):
                self.next()
                ty = self.type_name()
                self.expect("punct", ")")
                return Cast(type=ty, expr=self.unary())
        return self.postfix()

    def postfix(self):
        e = self.primary()
        while True:
            if self.accept("punct", "["):
                idx = self.expression()
                self.expect("punct", "]")
                e = Index(base=e, index=idx)
            elif self.at("punct", "."):
                dot_line = self.peek().line
                self.next()
                field = self.expect("ident").text
                e = Member(base=e, name=field, line=dot_line)
            elif self.at("punct", "(") and isinstance(e, Name):
                call_line = self.peek().line
                self.next()
                args = []
                if not self.at("punct", ")"):
                    while True:
                        args.append(self.expression())
                        if not self.accept("punct", ","):
                            break
                self.expect("punct", ")")
                e = Call(name=e.id, args=args, line=call_line)
            else:
                return e

    def primary(self):
        t = self.peek()
        if t.kind == "num":
            self.next()
            try:
                return Num(value=_num_value(t.text))
            except ValueError:
                raise ParseError(f"bad numeric literal {t.text!r}",
                                 file=self.filename, line=t.line,
                                 col=t.col)
        if t.kind == "ident":
            self.next()
            return Name(id=t.text)
        if self.accept("punct", "("):
            e = self.expression()
            self.expect("punct", ")")
            return e
        got = t.text if t.kind != "eof" else "<eof>"
        raise ParseError(f"unexpected token {got!r}",
                         file=self.filename, line=t.line, col=t.col)


def _num_value(text: str) -> Union[int, float]:
    if text.lower().startswith("0x"):
        # f/F are hex digits here, not float suffixes (0x1f == 31)
        return int(text.rstrip("uUlL"), 16)
    t = text.rstrip("fFuUlL")
    if "." in t or "e" in t.lower():
        return float(t)
    return int(t)
