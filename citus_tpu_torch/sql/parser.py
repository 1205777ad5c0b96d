"""Recursive-descent SQL parser.

Grammar scope: the analytic SQL surface the planner cascade supports
(SURVEY.md §7 — TPC-H-class SELECTs with joins/subqueries/CTEs, plus DDL,
INSERT, COPY, EXPLAIN, SET/SHOW).  Unsupported constructs raise ParseError
with position info.
"""

from __future__ import annotations

from ..errors import ParseError
from . import ast
from .lexer import Token, tokenize


def parse(sql: str) -> list[ast.Statement]:
    """Parse a semicolon-separated script into statements."""
    return Parser(tokenize(sql)).parse_script()


def parse_one(sql: str) -> ast.Statement:
    stmts = parse(sql)
    if len(stmts) != 1:
        raise ParseError(f"expected exactly one statement, got {len(stmts)}")
    return stmts[0]


class Parser:
    def __init__(self, tokens: list[Token]):
        self.tokens = tokens
        self.pos = 0

    # -- token helpers -----------------------------------------------------
    @property
    def cur(self) -> Token:
        return self.tokens[self.pos]

    def peek(self, ahead: int = 1) -> Token:
        return self.tokens[min(self.pos + ahead, len(self.tokens) - 1)]

    def advance(self) -> Token:
        tok = self.cur
        if tok.kind != "eof":
            self.pos += 1
        return tok

    def error(self, msg: str):
        tok = self.cur
        raise ParseError(f"{msg} near {tok.value!r}" if tok.value else msg,
                         tok.line, tok.column)

    def at_keyword(self, *words: str) -> bool:
        return self.cur.kind == "keyword" and self.cur.value in words

    def accept_keyword(self, *words: str) -> bool:
        if self.at_keyword(*words):
            self.advance()
            return True
        return False

    def expect_keyword(self, word: str) -> None:
        if not self.accept_keyword(word):
            self.error(f"expected {word.upper()}")

    def accept_word(self, word: str) -> bool:
        """Soft keyword: matches an ident OR keyword token by value, so
        the word stays usable as a column name elsewhere."""
        if self.cur.kind in ("ident", "keyword") and \
                self.cur.value == word:
            self.advance()
            return True
        return False

    def expect_word(self, word: str) -> None:
        if not self.accept_word(word):
            self.error(f"expected {word.upper()}")

    def at_op(self, *ops: str) -> bool:
        return self.cur.kind == "op" and self.cur.value in ops

    def accept_op(self, *ops: str) -> bool:
        if self.at_op(*ops):
            self.advance()
            return True
        return False

    def expect_op(self, op: str) -> None:
        if not self.accept_op(op):
            self.error(f"expected {op!r}")

    def expect_ident(self) -> str:
        if self.cur.kind == "ident":
            return self.advance().value
        # allow non-reserved-ish keywords as identifiers where unambiguous
        if self.cur.kind == "keyword" and self.cur.value in (
                "date", "text", "format", "header", "first", "last", "values"):
            return self.advance().value
        self.error("expected identifier")

    # -- script ------------------------------------------------------------
    def parse_script(self) -> list[ast.Statement]:
        stmts = []
        while self.cur.kind != "eof":
            if self.accept_op(";"):
                continue
            stmts.append(self.parse_statement())
            if self.cur.kind != "eof":
                self.expect_op(";")
        return stmts

    def parse_statement(self) -> ast.Statement:
        if self.at_keyword("select", "with"):
            return self.parse_select()
        if self.at_keyword("create"):
            return self.parse_create_table()
        if self.cur.kind in ("ident", "keyword") and \
                self.cur.value == "alter" and \
                self.peek().value == "table":
            return self.parse_alter_table()
        if self.at_keyword("drop"):
            return self.parse_drop_table()
        if self.at_keyword("insert"):
            return self.parse_insert()
        if self.at_keyword("update"):
            return self.parse_update()
        if self.at_keyword("delete"):
            return self.parse_delete()
        if self.at_keyword("merge"):
            return self.parse_merge()
        if self.at_keyword("copy"):
            return self.parse_copy()
        if self.at_keyword("explain"):
            return self.parse_explain()
        if self.at_keyword("set"):
            return self.parse_set()
        if self.at_keyword("show"):
            return self.parse_show()
        if self.at_keyword("begin", "start", "commit", "rollback", "abort",
                           "end"):
            return self.parse_transaction()
        if self.cur.kind in ("ident", "keyword") and \
                self.cur.value in ("prepare", "execute", "deallocate"):
            return self.parse_prepared()
        self.error("expected a statement")

    def parse_prepared(self) -> ast.Statement:
        word = self.cur.value
        self.advance()
        if word == "prepare":
            name = self.expect_ident()
            self.expect_keyword("as")
            return ast.Prepare(name, self.parse_statement())
        if word == "execute":
            name = self.expect_ident()
            args: list[ast.Expr] = []
            if self.accept_op("("):
                if not self.accept_op(")"):
                    while True:
                        args.append(self.parse_expr())
                        if not self.accept_op(","):
                            break
                    self.expect_op(")")
            return ast.ExecutePrepared(name, tuple(args))
        name = ("all" if self.cur.kind == "keyword"
                and self.cur.value == "all" else None)
        if name:
            self.advance()
        else:
            name = self.expect_ident()
        return ast.Deallocate(name)

    def parse_transaction(self) -> ast.TransactionStmt:
        if self.accept_keyword("begin"):
            self.accept_keyword("transaction") or self.accept_keyword("work")
            return ast.TransactionStmt("begin")
        if self.accept_keyword("start"):
            self.expect_keyword("transaction")
            return ast.TransactionStmt("begin")
        if self.accept_keyword("commit") or self.accept_keyword("end"):
            self.accept_keyword("transaction") or self.accept_keyword("work")
            return ast.TransactionStmt("commit")
        self.accept_keyword("rollback") or self.expect_keyword("abort")
        self.accept_keyword("transaction") or self.accept_keyword("work")
        return ast.TransactionStmt("rollback")

    # -- SELECT ------------------------------------------------------------
    def parse_select(self):
        """Full query expression: SELECT core, optional set operations
        (INTERSECT binds tighter than UNION/EXCEPT, PG precedence), and
        the trailing ORDER BY / LIMIT / OFFSET which scope to the whole
        compound.  Returns ast.Select or ast.SetOp."""
        ctes: list[ast.CommonTableExpr] = []
        if self.accept_keyword("with"):
            while True:
                name = self.expect_ident()
                col_names: tuple[str, ...] = ()
                if self.accept_op("("):
                    cols = [self.expect_ident()]
                    while self.accept_op(","):
                        cols.append(self.expect_ident())
                    self.expect_op(")")
                    col_names = tuple(cols)
                self.expect_keyword("as")
                self.expect_op("(")
                sub = self.parse_select()
                self.expect_op(")")
                ctes.append(ast.CommonTableExpr(name, sub, col_names))
                if not self.accept_op(","):
                    break

        node = self._parse_union_term()
        while self.at_keyword("union", "except"):
            op = self.advance().value
            all_flag = bool(self.accept_keyword("all"))
            if not all_flag:
                self.accept_keyword("distinct")
            node = ast.SetOp(op, all_flag, node, self._parse_union_term())

        order_by: list[ast.OrderItem] = []
        if self.accept_keyword("order"):
            self.expect_keyword("by")
            order_by.append(self.parse_order_item())
            while self.accept_op(","):
                order_by.append(self.parse_order_item())

        limit = offset = None
        while self.at_keyword("limit", "offset"):
            if self.accept_keyword("limit"):
                if self.accept_keyword("all"):
                    limit = None
                else:
                    limit = self._expect_integer()
            elif self.accept_keyword("offset"):
                offset = self._expect_integer()

        from dataclasses import replace as dc_replace

        if isinstance(node, ast.SetOp):
            return dc_replace(node, order_by=tuple(order_by), limit=limit,
                              offset=offset, ctes=tuple(ctes))
        if node.order_by or node.limit is not None or \
                node.offset is not None:
            # a parenthesized select with its own ORDER BY/LIMIT followed
            # by more: nothing to merge (outer clauses empty ⇒ keep inner)
            if order_by or limit is not None or offset is not None:
                self.error("conflicting ORDER BY/LIMIT placement")
            return dc_replace(node, ctes=tuple(ctes))
        return dc_replace(node, order_by=tuple(order_by), limit=limit,
                          offset=offset, ctes=tuple(ctes))

    def _parse_union_term(self):
        node = self._parse_query_primary()
        while self.at_keyword("intersect"):
            self.advance()
            all_flag = bool(self.accept_keyword("all"))
            if not all_flag:
                self.accept_keyword("distinct")
            node = ast.SetOp("intersect", all_flag, node,
                             self._parse_query_primary())
        return node

    def _parse_query_primary(self):
        if self.at_op("(") and self.peek().kind == "keyword" and \
                self.peek().value in ("select", "with"):
            self.expect_op("(")
            q = self.parse_select()
            self.expect_op(")")
            return q
        return self._parse_select_core()

    def _parse_select_core(self) -> ast.Select:
        self.expect_keyword("select")
        distinct = False
        if self.accept_keyword("distinct"):
            distinct = True
        elif self.accept_keyword("all"):
            pass
        items = [self.parse_select_item()]
        while self.accept_op(","):
            items.append(self.parse_select_item())

        from_items: list[ast.FromItem] = []
        if self.accept_keyword("from"):
            from_items.append(self.parse_from_item())
            while self.accept_op(","):
                from_items.append(self.parse_from_item())

        where = self.parse_expr() if self.accept_keyword("where") else None

        group_by: list[ast.Expr] = []
        if self.accept_keyword("group"):
            self.expect_keyword("by")
            group_by.append(self.parse_expr())
            while self.accept_op(","):
                group_by.append(self.parse_expr())

        having = self.parse_expr() if self.accept_keyword("having") else None

        return ast.Select(
            items=tuple(items), from_items=tuple(from_items), where=where,
            group_by=tuple(group_by), having=having, distinct=distinct)

    def _expect_number(self) -> str:
        if self.cur.kind != "number":
            self.error("expected a number")
        return self.advance().value

    def _expect_integer(self) -> int:
        if self.cur.kind != "number" or not self.cur.value.isdigit():
            self.error("expected an integer")
        return int(self.advance().value)

    def parse_select_item(self) -> ast.SelectItem:
        if self.at_op("*"):
            self.advance()
            return ast.SelectItem(ast.Star())
        expr = self.parse_expr()
        alias = None
        if self.accept_keyword("as"):
            alias = self.expect_ident()
        elif self.cur.kind == "ident":
            alias = self.advance().value
        return ast.SelectItem(expr, alias)

    def parse_order_item(self) -> ast.OrderItem:
        expr = self.parse_expr()
        descending = False
        if self.accept_keyword("desc"):
            descending = True
        elif self.accept_keyword("asc"):
            pass
        nulls_first = None
        if self.accept_keyword("nulls"):
            if self.accept_keyword("first"):
                nulls_first = True
            elif self.accept_keyword("last"):
                nulls_first = False
            else:
                self.error("expected FIRST or LAST")
        return ast.OrderItem(expr, descending, nulls_first)

    # -- FROM / joins ------------------------------------------------------
    def parse_from_item(self) -> ast.FromItem:
        left = self.parse_table_primary()
        while True:
            join_type = None
            if self.accept_keyword("cross"):
                self.expect_keyword("join")
                join_type = "cross"
            elif self.accept_keyword("inner"):
                self.expect_keyword("join")
                join_type = "inner"
            elif self.at_keyword("left", "right", "full"):
                join_type = self.advance().value
                self.accept_keyword("outer")
                self.expect_keyword("join")
            elif self.accept_keyword("join"):
                join_type = "inner"
            if join_type is None:
                return left
            right = self.parse_table_primary()
            condition = None
            using_cols: tuple[str, ...] = ()
            if join_type != "cross":
                if self.accept_keyword("using"):
                    # schema knowledge is needed to qualify the left side of
                    # USING; carry the column list and let the planner's
                    # binder expand it (ast.Join.using_cols)
                    self.expect_op("(")
                    cols = [self.expect_ident()]
                    while self.accept_op(","):
                        cols.append(self.expect_ident())
                    self.expect_op(")")
                    using_cols = tuple(cols)
                else:
                    self.expect_keyword("on")
                    condition = self.parse_expr()
            left = ast.Join(join_type, left, right, condition, using_cols)

    def parse_table_primary(self) -> ast.FromItem:
        if self.accept_op("("):
            if self.at_keyword("select", "with"):
                sub = self.parse_select()
                self.expect_op(")")
                self.accept_keyword("as")
                alias = self.expect_ident()
                return ast.SubqueryRef(sub, alias)
            item = self.parse_from_item()
            self.expect_op(")")
            return item
        name = self.expect_ident()
        alias = None
        if self.accept_keyword("as"):
            alias = self.expect_ident()
        elif self.cur.kind == "ident":
            alias = self.advance().value
        return ast.TableRef(name, alias)

    # -- expressions (precedence climbing) ---------------------------------
    def parse_expr(self) -> ast.Expr:
        return self.parse_or()

    def parse_or(self) -> ast.Expr:
        left = self.parse_and()
        while self.accept_keyword("or"):
            left = ast.BinaryOp("OR", left, self.parse_and())
        return left

    def parse_and(self) -> ast.Expr:
        left = self.parse_not()
        while self.accept_keyword("and"):
            left = ast.BinaryOp("AND", left, self.parse_not())
        return left

    def parse_not(self) -> ast.Expr:
        if self.accept_keyword("not"):
            return ast.UnaryOp("NOT", self.parse_not())
        return self.parse_comparison()

    def parse_comparison(self) -> ast.Expr:
        left = self.parse_additive()
        # IS [NOT] NULL
        if self.accept_keyword("is"):
            negated = bool(self.accept_keyword("not"))
            self.expect_keyword("null")
            return ast.IsNull(left, negated)
        negated = False
        if self.at_keyword("not") and self.peek().kind == "keyword" and \
                self.peek().value in ("between", "in", "like", "exists"):
            self.advance()
            negated = True
        if self.accept_keyword("between"):
            low = self.parse_additive()
            self.expect_keyword("and")
            high = self.parse_additive()
            return ast.Between(left, low, high, negated)
        if self.accept_keyword("in"):
            self.expect_op("(")
            if self.at_keyword("select", "with"):
                sub = self.parse_select()
                self.expect_op(")")
                return ast.InSubquery(left, sub, negated)
            items = [self.parse_expr()]
            while self.accept_op(","):
                items.append(self.parse_expr())
            self.expect_op(")")
            return ast.InList(left, tuple(items), negated)
        if self.accept_keyword("like"):
            return ast.Like(left, self.parse_additive(), negated)
        if negated:
            self.error("expected BETWEEN, IN, or LIKE after NOT")
        if self.cur.kind == "op" and self.cur.value in (
                "=", "<>", "!=", "<", "<=", ">", ">="):
            op = self.advance().value
            if op == "!=":
                op = "<>"
            right = self.parse_additive()
            return ast.BinaryOp(op, left, right)
        return left

    def parse_additive(self) -> ast.Expr:
        left = self.parse_multiplicative()
        while self.at_op("+", "-", "||"):
            op = self.advance().value
            left = ast.BinaryOp(op, left, self.parse_multiplicative())
        return left

    def parse_multiplicative(self) -> ast.Expr:
        left = self.parse_unary()
        while self.at_op("*", "/", "%"):
            op = self.advance().value
            left = ast.BinaryOp(op, left, self.parse_unary())
        return left

    def parse_unary(self) -> ast.Expr:
        if self.accept_op("-"):
            operand = self.parse_unary()
            if isinstance(operand, ast.Literal) and isinstance(
                    operand.value, (int, float)) and not operand.type_hint:
                return ast.Literal(-operand.value)
            return ast.UnaryOp("-", operand)
        if self.accept_op("+"):
            return self.parse_unary()
        return self.parse_postfix()

    def parse_postfix(self) -> ast.Expr:
        expr = self.parse_primary()
        while self.accept_op("::"):
            type_name = self._parse_type_name()
            expr = ast.Cast(expr, type_name)
        return expr

    def _parse_type_name(self) -> str:
        parts = [self.expect_ident() if self.cur.kind == "ident"
                 else self.advance().value]
        # double precision / character varying
        if parts[0] in ("double", "character") and self.cur.kind in (
                "ident", "keyword"):
            if self.cur.value in ("precision", "varying"):
                parts.append(self.advance().value)
        name = " ".join(parts)
        if self.accept_op("("):
            mods = [self._expect_number()]
            while self.accept_op(","):
                mods.append(self._expect_number())
            self.expect_op(")")
            name += f"({','.join(mods)})"
        return name

    def parse_primary(self) -> ast.Expr:
        tok = self.cur
        if tok.kind == "param":
            self.advance()
            return ast.Param(int(tok.value) - 1)
        if tok.kind == "number":
            self.advance()
            if "." in tok.value or "e" in tok.value or "E" in tok.value:
                return ast.Literal(float(tok.value))
            return ast.Literal(int(tok.value))
        if tok.kind == "string":
            self.advance()
            return ast.Literal(tok.value)
        if self.accept_keyword("true"):
            return ast.Literal(True)
        if self.accept_keyword("false"):
            return ast.Literal(False)
        if self.accept_keyword("null"):
            return ast.Literal(None)
        if self.accept_keyword("date"):
            if self.cur.kind == "string":
                return ast.Literal(self.advance().value, type_hint="date")
            # "date" used as identifier (column named date) — fall through
            return ast.ColumnRef("date")
        if self.accept_keyword("interval"):
            if self.cur.kind != "string":
                self.error("expected string after INTERVAL")
            text = self.advance().value
            unit = ""
            if self.cur.kind in ("ident", "keyword") and self.cur.value in (
                    "day", "days", "month", "months", "year", "years"):
                unit = self.advance().value.rstrip("s")
            else:
                # unit inside the string: '3 month'
                parts = text.split()
                if len(parts) == 2:
                    text, unit = parts[0], parts[1].rstrip("s")
            if unit not in ("day", "month", "year"):
                self.error("unsupported interval unit")
            try:
                quantity = int(text)
            except ValueError:
                self.error(f"invalid interval quantity {text!r}")
            return ast.Literal(quantity, type_hint="interval",
                               interval_unit=unit)
        if self.accept_keyword("cast"):
            self.expect_op("(")
            operand = self.parse_expr()
            self.expect_keyword("as")
            type_name = self._parse_type_name()
            self.expect_op(")")
            return ast.Cast(operand, type_name)
        if self.accept_keyword("extract"):
            self.expect_op("(")
            part = self.advance().value
            if part not in ("year", "month", "day"):
                self.error("unsupported EXTRACT field")
            self.expect_keyword("from")
            operand = self.parse_expr()
            self.expect_op(")")
            return ast.Extract(part, operand)
        if self.accept_keyword("substring"):
            self.expect_op("(")
            operand = self.parse_expr()
            if self.accept_keyword("from"):
                start = self.parse_expr()
                length = None
                if self.accept_keyword("for"):
                    length = self.parse_expr()
            else:
                self.expect_op(",")
                start = self.parse_expr()
                length = None
                if self.accept_op(","):
                    length = self.parse_expr()
            self.expect_op(")")
            return ast.Substring(operand, start, length)
        if self.accept_keyword("case"):
            whens = []
            while self.accept_keyword("when"):
                cond = self.parse_expr()
                self.expect_keyword("then")
                result = self.parse_expr()
                whens.append((cond, result))
            else_result = None
            if self.accept_keyword("else"):
                else_result = self.parse_expr()
            self.expect_keyword("end")
            if not whens:
                self.error("CASE needs at least one WHEN")
            return ast.CaseWhen(tuple(whens), else_result)
        if self.accept_keyword("exists"):
            self.expect_op("(")
            sub = self.parse_select()
            self.expect_op(")")
            return ast.Exists(sub)
        if self.accept_op("("):
            if self.at_keyword("select", "with"):
                sub = self.parse_select()
                self.expect_op(")")
                return ast.ScalarSubquery(sub)
            expr = self.parse_expr()
            self.expect_op(")")
            return expr
        if tok.kind == "ident" or (tok.kind == "keyword" and tok.value in (
                "left", "right", "values", "format", "text")):
            name = self.advance().value
            # function call
            if self.at_op("("):
                return self._parse_func_call(name)
            # qualified reference: t.col or t.*
            if self.accept_op("."):
                if self.accept_op("*"):
                    return ast.Star(table=name)
                col = self.expect_ident()
                return ast.ColumnRef(col, table=name)
            return ast.ColumnRef(name)
        self.error("expected an expression")

    def _parse_func_call(self, name: str) -> ast.Expr:
        self.expect_op("(")
        if self.accept_op("*"):
            self.expect_op(")")
            return self._maybe_over(ast.FuncCall(name.lower(), (),
                                                 star=True))
        distinct = bool(self.accept_keyword("distinct"))
        args: list[ast.Expr] = []
        if not self.at_op(")"):
            args.append(self.parse_expr())
            while self.accept_op(","):
                args.append(self.parse_expr())
        self.expect_op(")")
        return self._maybe_over(ast.FuncCall(name.lower(), tuple(args),
                                             distinct=distinct))

    def _maybe_over(self, call: ast.FuncCall) -> ast.FuncCall:
        if not self.accept_word("over"):
            return call
        self.expect_op("(")
        partition: list[ast.Expr] = []
        order: list[tuple[ast.Expr, bool]] = []
        if self.accept_word("partition"):
            self.expect_keyword("by")
            partition.append(self.parse_expr())
            while self.accept_op(","):
                partition.append(self.parse_expr())
        if self.accept_keyword("order"):
            self.expect_keyword("by")
            while True:
                e = self.parse_expr()
                desc = bool(self.accept_keyword("desc"))
                if not desc:
                    self.accept_keyword("asc")
                order.append((e, desc))
                if not self.accept_op(","):
                    break
        self.expect_op(")")
        from dataclasses import replace

        return replace(call, window=ast.WindowSpec(
            tuple(partition), tuple(order)))

    # -- DDL / DML ---------------------------------------------------------
    def parse_alter_table(self) -> ast.AlterTable:
        self.expect_word("alter")
        self.expect_keyword("table")
        table = self.expect_ident()
        if self.accept_word("add"):
            self.accept_word("column")
            if_not_exists = False
            if self.accept_keyword("if"):
                self.expect_keyword("not")
                self.expect_keyword("exists")
                if_not_exists = True
            spec = self._parse_column_spec()
            return ast.AlterTable(table, "add_column", column=spec,
                                  if_not_exists=if_not_exists)
        if self.accept_keyword("drop"):
            self.accept_word("column")
            if_exists = False
            if self.accept_keyword("if"):
                self.expect_keyword("exists")
                if_exists = True
            name = self.expect_ident()
            return ast.AlterTable(table, "drop_column", column_name=name,
                                  if_exists=if_exists)
        if self.accept_word("rename"):
            if self.accept_word("column"):
                old = self.expect_ident()
                self.expect_word("to")
                return ast.AlterTable(table, "rename_column",
                                      column_name=old,
                                      new_name=self.expect_ident())
            self.expect_word("to")
            return ast.AlterTable(table, "rename_table",
                                  new_name=self.expect_ident())
        self.error("expected ADD, DROP, or RENAME after ALTER TABLE")

    def _detokenize(self, start: int, end: int) -> str:
        """Re-serialize a token span to SQL text (view bodies persist as
        text in the catalog; there is no full deparser by design)."""
        parts = []
        for tok in self.tokens[start:end]:
            if tok.kind == "string":
                parts.append("'" + tok.value.replace("'", "''") + "'")
            else:
                parts.append(tok.value)
        return " ".join(parts)

    def parse_create_view(self) -> ast.Statement:
        or_replace = False
        if self.accept_word("or"):
            self.expect_word("replace")
            or_replace = True
        self.expect_word("view")
        name = self.expect_ident()
        columns: list[str] = []
        if self.accept_op("("):
            columns.append(self.expect_ident())
            while self.accept_op(","):
                columns.append(self.expect_ident())
            self.expect_op(")")
        self.expect_keyword("as")
        start = self.pos
        self.parse_select()  # validate the body now; store it as text
        return ast.CreateView(name, tuple(columns),
                              self._detokenize(start, self.pos),
                              or_replace)

    def parse_create_table(self) -> ast.Statement:
        self.expect_keyword("create")
        if self.cur.value in ("view", "or") and \
                self.cur.kind in ("ident", "keyword"):
            return self.parse_create_view()
        if self.accept_word("sequence"):
            name = self.expect_ident()
            start, increment = 1, 1
            while self.cur.kind in ("ident", "keyword"):
                if self.accept_word("start"):
                    self.accept_keyword("with")
                    start = self._expect_signed_integer()
                elif self.accept_word("increment"):
                    self.accept_keyword("by")
                    increment = self._expect_signed_integer()
                else:
                    self.error("expected START or INCREMENT")
            return ast.CreateSequence(name, start, increment)
        self.expect_keyword("table")
        if_not_exists = False
        if self.accept_keyword("if"):
            self.expect_keyword("not")
            self.expect_keyword("exists")
            if_not_exists = True
        name = self.expect_ident()
        self.expect_op("(")
        cols = [self._parse_column_spec()]
        while self.accept_op(","):
            cols.append(self._parse_column_spec())
        self.expect_op(")")
        return ast.CreateTable(name, tuple(cols), if_not_exists)

    def _parse_column_spec(self) -> ast.ColumnSpec:
        name = self.expect_ident()
        type_name = self._parse_type_name()
        not_null = False
        while True:
            if self.accept_keyword("not"):
                self.expect_keyword("null")
                not_null = True
            elif self.accept_keyword("null"):
                pass
            elif self.cur.kind == "ident" and self.cur.value in (
                    "primary", "key", "unique"):
                self.advance()  # constraints recorded nowhere (v1)
            else:
                break
        return ast.ColumnSpec(name, type_name, not_null)

    def parse_drop_table(self) -> ast.Statement:
        self.expect_keyword("drop")
        is_seq = self.accept_word("sequence")
        is_view = False if is_seq else self.accept_word("view")
        if not is_seq and not is_view:
            self.expect_keyword("table")
        if_exists = False
        if self.accept_keyword("if"):
            self.expect_keyword("exists")
            if_exists = True
        name = self.expect_ident()
        if is_seq:
            return ast.DropSequence(name, if_exists)
        if is_view:
            return ast.DropView(name, if_exists)
        return ast.DropTable(name, if_exists)

    def _expect_signed_integer(self) -> int:
        neg = self.accept_op("-")
        v = self._expect_integer()
        return -v if neg else v

    def parse_insert(self) -> ast.Statement:
        self.expect_keyword("insert")
        self.expect_keyword("into")
        table = self.expect_ident()
        columns: tuple[str, ...] = ()
        if self.accept_op("("):
            cols = [self.expect_ident()]
            while self.accept_op(","):
                cols.append(self.expect_ident())
            self.expect_op(")")
            columns = tuple(cols)
        if self.at_keyword("select", "with"):
            return ast.InsertSelect(table, columns, self.parse_select())
        self.expect_keyword("values")
        rows = []
        while True:
            self.expect_op("(")
            row = [self.parse_expr()]
            while self.accept_op(","):
                row.append(self.parse_expr())
            self.expect_op(")")
            rows.append(tuple(row))
            if not self.accept_op(","):
                break
        return ast.InsertValues(table, columns, tuple(rows))

    def _parse_table_alias(self) -> str | None:
        if self.accept_keyword("as"):
            return self.expect_ident()
        if self.cur.kind == "ident":
            return self.advance().value
        return None

    def _parse_assignments(self) -> tuple[ast.Assignment, ...]:
        self.expect_keyword("set")
        assigns = []
        while True:
            col = self.expect_ident()
            self.expect_op("=")
            assigns.append(ast.Assignment(col, self.parse_expr()))
            if not self.accept_op(","):
                return tuple(assigns)

    def parse_update(self) -> ast.Update:
        self.expect_keyword("update")
        table = self.expect_ident()
        alias = self._parse_table_alias()
        assigns = self._parse_assignments()
        where = self.parse_expr() if self.accept_keyword("where") else None
        return ast.Update(table, alias, assigns, where)

    def parse_delete(self) -> ast.Delete:
        self.expect_keyword("delete")
        self.expect_keyword("from")
        table = self.expect_ident()
        alias = self._parse_table_alias()
        where = self.parse_expr() if self.accept_keyword("where") else None
        return ast.Delete(table, alias, where)

    def parse_merge(self) -> ast.Merge:
        self.expect_keyword("merge")
        self.expect_keyword("into")
        target = self.expect_ident()
        target_alias = self._parse_table_alias()
        self.expect_keyword("using")
        source = self.parse_table_primary()
        self.expect_keyword("on")
        on = self.parse_expr()
        matched: list[ast.MergeAction] = []
        not_matched: list[ast.MergeAction] = []
        while self.accept_keyword("when"):
            negated = self.accept_keyword("not")
            self.expect_keyword("matched")
            cond = self.parse_expr() if self.accept_keyword("and") else None
            self.expect_keyword("then")
            if self.accept_keyword("do"):
                self.expect_keyword("nothing")
                action = ast.MergeAction("nothing", cond)
            elif negated:
                self.expect_keyword("insert")
                cols: tuple[str, ...] = ()
                if self.accept_op("("):
                    names = [self.expect_ident()]
                    while self.accept_op(","):
                        names.append(self.expect_ident())
                    self.expect_op(")")
                    cols = tuple(names)
                self.expect_keyword("values")
                self.expect_op("(")
                vals = [self.parse_expr()]
                while self.accept_op(","):
                    vals.append(self.parse_expr())
                self.expect_op(")")
                action = ast.MergeAction("insert", cond,
                                         insert_columns=cols,
                                         insert_values=tuple(vals))
            elif self.accept_keyword("delete"):
                action = ast.MergeAction("delete", cond)
            else:
                self.expect_keyword("update")
                action = ast.MergeAction("update", cond,
                                         assignments=self._parse_assignments())
            (not_matched if negated else matched).append(action)
        if not matched and not not_matched:
            self.error("MERGE needs at least one WHEN clause")
        return ast.Merge(target, target_alias, source, on,
                         tuple(matched), tuple(not_matched))

    def parse_copy(self) -> ast.CopyFrom:
        self.expect_keyword("copy")
        table = self.expect_ident()
        self.expect_keyword("from")
        if self.cur.kind != "string":
            self.error("expected file path string")
        path = self.advance().value
        fmt, delim, header, null_s = "csv", ",", False, ""
        if self.accept_keyword("with"):
            self.expect_op("(")
            while True:
                opt = self.advance().value
                if opt == "format":
                    fmt = self.advance().value
                elif opt == "delimiter":
                    delim = self.advance().value
                elif opt == "header":
                    if self.cur.kind == "keyword" and self.cur.value in (
                            "true", "false"):
                        header = self.advance().value == "true"
                    else:
                        header = True
                elif opt == "null":
                    null_s = self.advance().value
                else:
                    self.error(f"unknown COPY option {opt!r}")
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        return ast.CopyFrom(table, path, fmt, delim, header, null_s)

    def parse_explain(self) -> ast.Explain:
        self.expect_keyword("explain")
        analyze = verbose = False
        if self.accept_op("("):
            while True:
                word = self.advance().value
                if word == "analyze":
                    analyze = True
                elif word == "verbose":
                    verbose = True
                else:
                    self.error(f"unknown EXPLAIN option {word!r}")
                if not self.accept_op(","):
                    break
            self.expect_op(")")
        else:
            if self.accept_keyword("analyze"):
                analyze = True
            if self.accept_keyword("verbose"):
                verbose = True
        return ast.Explain(self.parse_statement(), analyze, verbose)

    def parse_set(self) -> ast.SetVariable:
        self.expect_keyword("set")
        name = self.expect_ident()
        # allow citus_tpu.xxx / citus.xxx prefixes
        while self.accept_op("."):
            name = self.expect_ident()
        if not self.accept_op("="):
            if not (self.cur.kind == "ident" and self.cur.value == "to"):
                self.error("expected = or TO")
            self.advance()
        if self.cur.kind in ("string", "number"):
            raw = self.advance()
            value: object = raw.value
            if raw.kind == "number":
                value = float(raw.value) if "." in raw.value else int(raw.value)
        elif self.cur.kind in ("ident", "keyword"):
            value = self.advance().value
        else:
            self.error("expected a value")
        return ast.SetVariable(name, value)

    def parse_show(self) -> ast.ShowVariable:
        self.expect_keyword("show")
        if self.accept_keyword("all"):
            return ast.ShowVariable("all")
        name = self.expect_ident()
        while self.accept_op("."):
            name = self.expect_ident()
        return ast.ShowVariable(name)
