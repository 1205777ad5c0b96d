"""SQL lexer: hand-written, position-tracking.

The reference reuses PostgreSQL's scanner; this framework owns its own SQL
surface so tokenization lives here.  Produces a flat token list the
recursive-descent parser consumes.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..errors import ParseError

KEYWORDS = frozenset("""
select from where group by having order limit offset as and or not in is null
like between distinct case when then else end join inner left right full outer
cross on create table drop insert into values copy with delimiter header format
csv text exists interval date cast extract substring for if asc desc nulls
first last set show explain analyze verbose union intersect except all
true false using
update delete merge matched do nothing returning
begin commit rollback abort transaction work start
""".split())

# multi-char operators first (longest match)
OPERATORS = ["<>", "!=", "<=", ">=", "||", "::",
             "=", "<", ">", "+", "-", "*", "/", "%",
             "(", ")", ",", ";", "."]


@dataclass(frozen=True)
class Token:
    kind: str    # keyword | ident | number | string | op | eof
    value: str   # normalized: keywords/idents lowercased (unless quoted)
    line: int
    column: int

    def __repr__(self):
        return f"Token({self.kind},{self.value!r})"


def tokenize(sql: str) -> list[Token]:
    tokens: list[Token] = []
    i, line, col = 0, 1, 1
    n = len(sql)

    def err(msg):
        raise ParseError(msg, line, col)

    while i < n:
        ch = sql[i]
        # whitespace
        if ch in " \t\r\n":
            if ch == "\n":
                line += 1
                col = 1
            else:
                col += 1
            i += 1
            continue
        # line comment
        if sql.startswith("--", i):
            j = sql.find("\n", i)
            i = n if j == -1 else j
            continue
        # block comment
        if sql.startswith("/*", i):
            j = sql.find("*/", i + 2)
            if j == -1:
                err("unterminated /* comment")
            for k in range(i, j + 2):
                if sql[k] == "\n":
                    line += 1
                    col = 1
                else:
                    col += 1
            i = j + 2
            continue
        start_line, start_col = line, col
        # prepared-statement parameter: $1, $2, ...
        if ch == "$" and i + 1 < n and sql[i + 1].isdigit():
            j = i + 1
            while j < n and sql[j].isdigit():
                j += 1
            tokens.append(Token("param", sql[i + 1:j],
                                start_line, start_col))
            col += j - i
            i = j
            continue
        # string literal with '' escape
        if ch == "'":
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    err("unterminated string literal")
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            tokens.append(Token("string", "".join(buf), start_line, start_col))
            for k in range(i, j + 1):
                if sql[k] == "\n":
                    line += 1
                    col = 1
                else:
                    col += 1
            i = j + 1
            continue
        # quoted identifier with "" escape
        if ch == '"':
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    err("unterminated quoted identifier")
                if sql[j] == '"':
                    if j + 1 < n and sql[j + 1] == '"':
                        buf.append('"')
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            tokens.append(Token("ident", "".join(buf), start_line, start_col))
            for k in range(i, j + 1):
                if sql[k] == "\n":
                    line += 1
                    col = 1
                else:
                    col += 1
            i = j + 1
            continue
        # number
        if ch.isdigit() or (ch == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = seen_exp = False
            while j < n:
                c = sql[j]
                if c.isdigit():
                    j += 1
                elif c == "." and not seen_dot and not seen_exp:
                    seen_dot = True
                    j += 1
                elif c in "eE" and not seen_exp and j > i:
                    # exponent only if digits follow (else '1e' is ident-ish junk)
                    k = j + 1
                    if k < n and sql[k] in "+-":
                        k += 1
                    if k < n and sql[k].isdigit():
                        seen_exp = True
                        j = k
                    else:
                        break
                else:
                    break
            if j < n and (sql[j].isalpha() or sql[j] == "_"):
                err(f"trailing junk after numeric literal: {sql[i:j+1]!r}")
            tokens.append(Token("number", sql[i:j], start_line, start_col))
            col += j - i
            i = j
            continue
        # identifier / keyword
        if ch.isalpha() or ch == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            word = sql[i:j].lower()
            kind = "keyword" if word in KEYWORDS else "ident"
            tokens.append(Token(kind, word, start_line, start_col))
            col += j - i
            i = j
            continue
        # operator
        for op in OPERATORS:
            if sql.startswith(op, i):
                tokens.append(Token("op", op, start_line, start_col))
                col += len(op)
                i += len(op)
                break
        else:
            err(f"unexpected character {ch!r}")
    tokens.append(Token("eof", "", line, col))
    return tokens
