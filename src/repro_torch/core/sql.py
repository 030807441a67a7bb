"""SQL front end (paper §2.4).

Query compilation follows the paper's three steps: parse to an AST, build a
logical plan with basic optimization (predicate pushdown), emit a physical
plan of RDD transformations.  The dialect covers the paper's workloads:

  SELECT <exprs|aggregates> FROM t [AS a][, u [AS b] | JOIN u ON k]
    [WHERE pred] [GROUP BY exprs] [HAVING pred]
    [ORDER BY col [DESC], ...] [LIMIT n]

  CREATE TABLE name [TBLPROPERTIES ("shark.cache"="true"
    [, "copartition"="other"])] AS SELECT ... [DISTRIBUTE BY col]

Comma-joins with equi-join predicates in WHERE (the Pavlo join query's form)
are recognized and turned into JoinNodes; remaining conjuncts stay filters.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional, Sequence, Tuple

from .expr import (And, Between, BinOp, Cmp, Col, Expr, Func, InList, Lit,
                   Not, Or, conjoin, rewrite_expr, split_conjuncts)
from .plan import (AggFunc, AggregateNode, AggSpec, FilterNode, JoinNode,
                   LimitNode, Node, ProjectNode, ScanNode, SortNode)

KEYWORDS = {
    "SELECT", "FROM", "WHERE", "GROUP", "BY", "ORDER", "LIMIT", "AS", "AND",
    "OR", "NOT", "JOIN", "ON", "INNER", "LEFT", "OUTER", "CREATE", "TABLE",
    "TBLPROPERTIES", "DISTRIBUTE", "BETWEEN", "IN", "DESC", "ASC", "DISTINCT",
    "INTO", "TEMP", "DATE", "HAVING",
}

AGG_FUNCS = {"COUNT": AggFunc.COUNT, "SUM": AggFunc.SUM, "AVG": AggFunc.AVG,
             "MIN": AggFunc.MIN, "MAX": AggFunc.MAX}

_TOKEN_RE = re.compile(r"""
    \s*(?:
      (?P<number>\d+\.\d+|\.\d+|\d+)
    | (?P<string>'(?:[^']|'')*')
    | (?P<name>[A-Za-z_][A-Za-z_0-9]*(?:\.[A-Za-z_][A-Za-z_0-9]*)?)
    | (?P<op><>|!=|>=|<=|=|<|>|\+|-|\*|/|%|\(|\)|,|;)
    )""", re.VERBOSE)


@dataclasses.dataclass
class Token:
    kind: str  # number | string | name | keyword | op | eof
    value: str


def tokenize(sql: str) -> List[Token]:
    out: List[Token] = []
    pos = 0
    while pos < len(sql):
        m = _TOKEN_RE.match(sql, pos)
        if not m:
            if sql[pos:].strip() == "":
                break
            raise SyntaxError(f"cannot tokenize near: {sql[pos:pos+32]!r}")
        pos = m.end()
        if m.lastgroup == "number":
            out.append(Token("number", m.group("number")))
        elif m.lastgroup == "string":
            raw = m.group("string")[1:-1].replace("''", "'")
            out.append(Token("string", raw))
        elif m.lastgroup == "name":
            name = m.group("name")
            if name.upper() in KEYWORDS:
                out.append(Token("keyword", name.upper()))
            else:
                out.append(Token("name", name))
        else:
            out.append(Token("op", m.group("op")))
    out.append(Token("eof", ""))
    return out


@dataclasses.dataclass
class SelectStmt:
    select: List[Tuple[Optional[str], object]]  # (alias, Expr|AggSpec-ish)
    from_items: List[Tuple[str, str]]           # (table, alias)
    joins: List[Tuple[str, str, Expr, str]]     # (table, alias, on, how)
    where: Optional[Expr]
    group_by: List[Expr]
    order_by: List[Tuple[str, bool]]
    limit: Optional[int]
    distribute_by: Optional[str]
    having: Optional[Expr] = None


@dataclasses.dataclass
class CreateStmt:
    name: str
    properties: Dict[str, str]
    select: SelectStmt


@dataclasses.dataclass
class _AggCall:
    func: AggFunc
    arg: Optional[Expr]
    distinct: bool = False


class Parser:
    def __init__(self, sql: str):
        self.toks = tokenize(sql)
        self.i = 0

    # -- token helpers -------------------------------------------------------

    def peek(self) -> Token:
        return self.toks[self.i]

    def next(self) -> Token:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, kind: str, value: Optional[str] = None) -> Optional[Token]:
        t = self.peek()
        if t.kind == kind and (value is None or t.value == value):
            return self.next()
        return None

    def expect(self, kind: str, value: Optional[str] = None) -> Token:
        t = self.accept(kind, value)
        if t is None:
            raise SyntaxError(f"expected {value or kind}, got "
                              f"{self.peek().kind}:{self.peek().value!r}")
        return t

    # -- grammar ---------------------------------------------------------------

    def parse(self):
        if self.peek().kind == "keyword" and self.peek().value == "CREATE":
            return self.create_stmt()
        stmt = self.select_stmt()
        self.accept("op", ";")
        return stmt

    def create_stmt(self) -> CreateStmt:
        self.expect("keyword", "CREATE")
        self.expect("keyword", "TABLE")
        name = self.expect("name").value
        props: Dict[str, str] = {}
        if self.accept("keyword", "TBLPROPERTIES"):
            self.expect("op", "(")
            while True:
                k = self.expect("string").value
                self.expect("op", "=")
                v = self.expect("string").value
                props[k] = v
                if not self.accept("op", ","):
                    break
            self.expect("op", ")")
        self.expect("keyword", "AS")
        sel = self.select_stmt()
        self.accept("op", ";")
        return CreateStmt(name, props, sel)

    def select_stmt(self) -> SelectStmt:
        self.expect("keyword", "SELECT")
        self.accept("keyword", "INTO") and self.expect("keyword", "TEMP")
        select: List[Tuple[Optional[str], object]] = []
        while True:
            if self.accept("op", "*"):
                select.append((None, "*"))
            else:
                e = self.expr()
                alias = None
                if self.accept("keyword", "AS"):
                    alias = self.expect("name").value
                elif self.peek().kind == "name":
                    alias = self.next().value
                select.append((alias, e))
            if not self.accept("op", ","):
                break
        self.expect("keyword", "FROM")
        from_items: List[Tuple[str, str]] = []
        joins: List[Tuple[str, str, Expr, str]] = []
        t, a = self._table_ref()
        from_items.append((t, a))
        while True:
            if self.accept("op", ","):
                t, a = self._table_ref()
                from_items.append((t, a))
                continue
            how = "inner"
            if self.accept("keyword", "LEFT"):
                self.accept("keyword", "OUTER")
                how = "left"
                self.expect("keyword", "JOIN")
            elif self.accept("keyword", "INNER"):
                self.expect("keyword", "JOIN")
            elif not self.accept("keyword", "JOIN"):
                break
            t, a = self._table_ref()
            self.expect("keyword", "ON")
            on = self.expr()
            joins.append((t, a, on, how))
        where = None
        if self.accept("keyword", "WHERE"):
            where = self.expr()
        group_by: List[Expr] = []
        if self.accept("keyword", "GROUP"):
            self.expect("keyword", "BY")
            group_by.append(self.expr())
            while self.accept("op", ","):
                group_by.append(self.expr())
        having = None
        if self.accept("keyword", "HAVING"):
            having = self.expr()
        order_by: List[Tuple[str, bool]] = []
        if self.accept("keyword", "ORDER"):
            self.expect("keyword", "BY")
            while True:
                col = self.expect("name").value
                desc = bool(self.accept("keyword", "DESC"))
                if not desc:
                    self.accept("keyword", "ASC")
                order_by.append((col, desc))
                if not self.accept("op", ","):
                    break
        limit = None
        if self.accept("keyword", "LIMIT"):
            limit = int(self.expect("number").value)
        distribute_by = None
        if self.accept("keyword", "DISTRIBUTE"):
            self.expect("keyword", "BY")
            distribute_by = self.expect("name").value
        return SelectStmt(select, from_items, joins, where, group_by,
                          order_by, limit, distribute_by, having)

    def _table_ref(self) -> Tuple[str, str]:
        t = self.expect("name").value
        alias = t
        if self.accept("keyword", "AS"):
            alias = self.expect("name").value
        elif self.peek().kind == "name":
            alias = self.next().value
        return t, alias

    # -- expressions -------------------------------------------------------

    def expr(self) -> Expr:
        return self._or()

    def _or(self) -> Expr:
        e = self._and()
        while self.accept("keyword", "OR"):
            e = Or(e, self._and())
        return e

    def _and(self) -> Expr:
        e = self._not()
        while self.accept("keyword", "AND"):
            e = And(e, self._not())
        return e

    def _not(self) -> Expr:
        if self.accept("keyword", "NOT"):
            return Not(self._not())
        return self._cmp()

    def _cmp(self) -> Expr:
        e = self._add()
        t = self.peek()
        if t.kind == "op" and t.value in ("=", "!=", "<>", "<", "<=", ">", ">="):
            self.next()
            op = "!=" if t.value == "<>" else t.value
            return Cmp(op, e, self._add())
        if t.kind == "keyword" and t.value == "BETWEEN":
            self.next()
            lo = self._add()
            self.expect("keyword", "AND")
            hi = self._add()
            return Between(e, _litval(lo), _litval(hi))
        if t.kind == "keyword" and t.value == "NOT":
            # NOT IN / NOT BETWEEN
            save = self.i
            self.next()
            if self.accept("keyword", "IN"):
                self.expect("op", "(")
                vals = [self._literal_value()]
                while self.accept("op", ","):
                    vals.append(self._literal_value())
                self.expect("op", ")")
                return Not(InList(e, tuple(vals)))
            self.i = save
        if t.kind == "keyword" and t.value == "IN":
            self.next()
            self.expect("op", "(")
            vals = [self._literal_value()]
            while self.accept("op", ","):
                vals.append(self._literal_value())
            self.expect("op", ")")
            return InList(e, tuple(vals))
        return e

    def _add(self) -> Expr:
        e = self._mul()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("+", "-"):
                self.next()
                e = BinOp(t.value, e, self._mul())
            else:
                return e

    def _mul(self) -> Expr:
        e = self._unary()
        while True:
            t = self.peek()
            if t.kind == "op" and t.value in ("*", "/", "%"):
                self.next()
                e = BinOp(t.value, e, self._unary())
            else:
                return e

    def _unary(self) -> Expr:
        if self.accept("op", "-"):
            return BinOp("-", Lit(0), self._unary())
        return self._atom()

    def _literal_value(self):
        neg = bool(self.accept("op", "-"))
        t = self.next()
        if t.kind == "number":
            v = float(t.value) if "." in t.value else int(t.value)
            return -v if neg else v
        if t.kind == "string" and not neg:
            return t.value
        raise SyntaxError(f"expected literal, got {t.value!r}")

    def _atom(self) -> Expr:
        t = self.peek()
        if t.kind == "number":
            self.next()
            v = float(t.value) if "." in t.value else int(t.value)
            return Lit(v)
        if t.kind == "string":
            self.next()
            return Lit(t.value)
        if t.kind == "keyword" and t.value == "DATE":
            # Date('2000-01-15') -> days since epoch literal
            self.next()
            self.expect("op", "(")
            s = self.expect("string").value
            self.expect("op", ")")
            return Lit(_date_to_days(s))
        if t.kind == "name":
            name = self.next().value
            upper = name.upper()
            if self.accept("op", "("):
                if upper in AGG_FUNCS:
                    distinct = bool(self.accept("keyword", "DISTINCT"))
                    if self.accept("op", "*"):
                        arg = None
                    else:
                        arg = self.expr()
                    self.expect("op", ")")
                    return _AggExpr(AGG_FUNCS[upper], arg, distinct)
                args = []
                if not self.accept("op", ")"):
                    args.append(self.expr())
                    while self.accept("op", ","):
                        args.append(self.expr())
                    self.expect("op", ")")
                return Func(upper, tuple(args))
            return Col(name)
        if self.accept("op", "("):
            e = self.expr()
            self.expect("op", ")")
            return e
        raise SyntaxError(f"unexpected token {t.kind}:{t.value!r}")


@dataclasses.dataclass(eq=False)
class _AggExpr(Expr):
    """Aggregate call inside a select list (resolved by the binder)."""
    func: AggFunc
    arg: Optional[Expr]
    distinct: bool

    def children(self):
        return (self.arg,) if self.arg is not None else ()

    def __repr__(self):
        d = "DISTINCT " if self.distinct else ""
        return f"{self.func.value}({d}{self.arg if self.arg is not None else '*'})"


def _litval(e: Expr):
    # fold the unary-minus encoding (0 - x) back into a negative literal
    if (isinstance(e, BinOp) and e.op == "-" and isinstance(e.left, Lit)
            and e.left.value == 0 and isinstance(e.right, Lit)):
        return -e.right.value
    assert isinstance(e, Lit), f"expected literal, got {e}"
    return e.value


def _date_to_days(s: str) -> int:
    import datetime
    d = datetime.date.fromisoformat(s)
    return (d - datetime.date(1970, 1, 1)).days


# ---------------------------------------------------------------------------
# Binder: SelectStmt -> logical plan
# ---------------------------------------------------------------------------


class Binder:
    def __init__(self, catalog):
        self.catalog = catalog

    def bind(self, stmt: SelectStmt) -> Node:
        # resolve FROM: build scan/join tree
        alias_schema: Dict[str, List[str]] = {}
        for t, a in stmt.from_items:
            alias_schema[a] = list(self.catalog.schema(t).names)
        for t, a, _, _ in stmt.joins:
            alias_schema[a] = list(self.catalog.schema(t).names)

        def resolve(col: str) -> str:
            if "." in col:
                a, c = col.split(".", 1)
                if a in alias_schema and c in alias_schema[a]:
                    return c
                raise KeyError(f"cannot resolve {col}")
            return col

        def strip_quals(e: Expr) -> Expr:
            if isinstance(e, Col):
                return Col(resolve(e.name))
            import copy
            c = copy.copy(e)
            for attr in ("left", "right"):
                if hasattr(c, attr):
                    setattr(c, attr, strip_quals(getattr(c, attr)))
            if hasattr(c, "child") and isinstance(getattr(c, "child"), Expr):
                c.child = strip_quals(c.child)
            if hasattr(c, "args"):
                c.args = tuple(strip_quals(x) for x in c.args)
            if isinstance(c, _AggExpr) and c.arg is not None:
                c.arg = strip_quals(c.arg)
            return c

        where = strip_quals(stmt.where) if stmt.where is not None else None

        # Build the left-deep join tree over ALL from-items: explicit
        # JOIN ... ON clauses and comma tables (whose equi predicates live in
        # WHERE) bind in user order where possible, deferring any item whose
        # join keys reference a table that is not bound yet — so arbitrary
        # N-way mixes like `FROM f JOIN d1 ON ..., d2 WHERE f.x = d2.k`
        # resolve regardless of reference order.  The cost-based ordering
        # pass (plan.order_joins) then picks the initial execution order.
        node: Node = ScanNode(stmt.from_items[0][0])
        bound_aliases = [stmt.from_items[0][1]]
        pending: List[tuple] = (
            [("join", t, a, on, how) for t, a, on, how in stmt.joins]
            + [("comma", t, a, None, "inner") for t, a in stmt.from_items[1:]])
        remaining = list(split_conjuncts(where)) if where is not None else []
        while pending:
            progressed = False
            for pi, item in enumerate(pending):
                kind, t, a, on, how = item
                if kind == "join":
                    keys = self._try_equi(on, alias_schema, bound_aliases, a)
                    if not keys:
                        continue
                    lk, rk = keys
                else:
                    found = None
                    for c in remaining:
                        keys = self._try_equi(c, alias_schema, bound_aliases, a)
                        if keys:
                            found = (c, keys)
                            break
                    if not found:
                        continue
                    c, (lk, rk) = found
                    # remove by identity: Expr overloads == into a Cmp node
                    remaining = [x for x in remaining if x is not c]
                node = JoinNode(node, ScanNode(t), lk, rk, how)
                bound_aliases.append(a)
                del pending[pi]
                progressed = True
                break
            if not progressed:
                kind, t, a, on, how = pending[0]
                if kind == "join":
                    raise NotImplementedError(
                        f"unsupported join condition {on} for table {t}")
                raise NotImplementedError(
                    f"no equi-join predicate found for table {t}")
        if stmt.from_items[1:]:
            where = conjoin(remaining)

        if where is not None:
            node = FilterNode(node, where)

        # aggregation?
        has_agg = any(isinstance(e, _AggExpr) or _contains_agg(e)
                      for _, e in stmt.select if not isinstance(e, str))
        if stmt.having is not None and not (stmt.group_by or has_agg):
            raise ValueError("HAVING requires GROUP BY or an aggregate "
                             "in the SELECT list")
        if stmt.group_by or has_agg:
            items = [(alias, e if isinstance(e, str) else strip_quals(e))
                     for alias, e in stmt.select]
            group_exprs = [strip_quals(g) for g in stmt.group_by]
            having = (strip_quals(stmt.having)
                      if stmt.having is not None else None)
            node = bind_aggregate(self.catalog, node, items, group_exprs,
                                  having)
        else:
            exprs: List[Tuple[str, Expr]] = []
            star = any(isinstance(e, str) for _, e in stmt.select)
            if star:
                for a in bound_aliases:
                    # expansion by schema order; duplicate names suffixed later
                    pass
                all_cols: List[str] = []
                for t, al in (stmt.from_items + [(t, a2) for t, a2, _, _ in stmt.joins]):
                    for c in self.catalog.schema(t).names:
                        if c not in all_cols:
                            all_cols.append(c)
                exprs.extend((c, Col(c)) for c in all_cols)
            for alias, e in stmt.select:
                if isinstance(e, str):
                    continue
                e = strip_quals(e)
                name = alias or _auto_name(e)
                exprs.append((name, e))
            if not (star and len(exprs) == len([1 for _, e in stmt.select if isinstance(e, str)])):
                node = ProjectNode(node, exprs) if exprs else node

        if stmt.order_by:
            node = SortNode(node, [(c, d) for c, d in stmt.order_by])
        if stmt.limit is not None:
            node = LimitNode(node, stmt.limit)
        return node

    def _try_equi(self, c: Expr, alias_schema, left_aliases, right_alias):
        if not isinstance(c, Cmp) or c.op != "=":
            return None
        if not (isinstance(c.left, Col) and isinstance(c.right, Col)):
            return None

        def side(col: str):
            if "." in col:
                a, name = col.split(".", 1)
                if a == right_alias:
                    return "right", name
                if a in left_aliases:
                    return "left", name
                return None, col
            # unqualified: search
            if col in alias_schema.get(right_alias, []):
                return "right", col
            for a in left_aliases:
                if col in alias_schema.get(a, []):
                    return "left", col
            return None, col

        s1, n1 = side(c.left.name)
        s2, n2 = side(c.right.name)
        if s1 == "left" and s2 == "right":
            return n1, n2
        if s1 == "right" and s2 == "left":
            return n2, n1
        return None


# ---------------------------------------------------------------------------
# Aggregate binding — shared by the SQL binder and SharkFrame (core/frame.py)
# ---------------------------------------------------------------------------


def bind_aggregate(catalog, child: Node,
                   select_items: Sequence[Tuple[Optional[str], object]],
                   group_exprs: Sequence[Expr],
                   having: Optional[Expr] = None) -> Node:
    """Build pre-project -> Aggregate [-> HAVING filter] [-> post-project].

    `select_items` is the resolved output list: (alias-or-None, Expr|_AggExpr)
    pairs, qualifier-stripped.  Both query surfaces — the SQL binder and the
    fluent SharkFrame API — funnel through this one function, so a frame-built
    aggregation and its SQL-text twin produce byte-identical logical plans
    (and therefore share one plan-fingerprint result-cache entry)."""
    group_exprs = list(group_exprs)
    # pre-project: group expressions become named columns; agg args keep
    # base columns.
    pre: List[Tuple[str, Expr]] = []
    group_names: List[str] = []
    for i, g in enumerate(group_exprs):
        if isinstance(g, Col):
            group_names.append(g.name)
            pre.append((g.name, g))
        else:
            gname = f"__g{i}"
            group_names.append(gname)
            pre.append((gname, g))
    aggs: List[AggSpec] = []
    agg_out: Dict[Tuple, str] = {}           # (func, arg repr, distinct) -> out
    select_out: List[Tuple[str, str]] = []   # (out name, source col)
    for alias, e in select_items:
        if isinstance(e, str):
            raise NotImplementedError("SELECT * with GROUP BY")
        if isinstance(e, _AggExpr):
            name = alias or _auto_name(e)
            func = (AggFunc.COUNT_DISTINCT
                    if (e.func == AggFunc.COUNT and e.distinct) else e.func)
            aggs.append(AggSpec(name, func, e.arg))
            agg_out.setdefault((e.func, repr(e.arg), e.distinct), name)
            select_out.append((name, name))
            # agg args reference base columns: ensure they pass through
            if e.arg is not None:
                for c in e.arg.columns():
                    if all(p[0] != c for p in pre):
                        pre.append((c, Col(c)))
        else:
            # must match a group expression
            matched = None
            for gname, g in zip(group_names, group_exprs):
                if repr(e) == repr(g) or (isinstance(e, Col)
                                          and e.name == gname):
                    matched = gname
                    break
            if matched is None:
                raise ValueError(f"non-aggregate select expr {e} not in "
                                 f"GROUP BY")
            select_out.append((alias or _auto_name(e), matched))
    if not pre:
        # COUNT(*)-style aggregates need at least one column to carry the
        # row count through the pre-projection
        first_col = child.schema(catalog).names[0]
        pre = [(first_col, Col(first_col))]
    node: Node = ProjectNode(child, pre)
    node = AggregateNode(node, group_names, aggs)
    if having is not None:
        visible_to_src = {name: src for name, src in select_out}
        available = set(group_names) | {a.out_name for a in aggs}
        node = FilterNode(node, _resolve_having(having, agg_out,
                                                visible_to_src, available))
    # post-project for aliasing/ordering
    out_exprs = [(name, Col(src)) for name, src in select_out]
    if [n for n, _ in out_exprs] != group_names + [a.out_name for a in aggs] \
            or any(n != s for n, s in select_out):
        node = ProjectNode(node, out_exprs)
    return node


def _resolve_having(e: Expr, agg_out: Dict[Tuple, str],
                    visible_to_src: Dict[str, str], available: set) -> Expr:
    """Rewrite a HAVING predicate against the aggregate's output: aggregate
    calls resolve to their SELECT alias, output aliases to internal names."""

    def resolve(n: Expr) -> Optional[Expr]:
        if isinstance(n, _AggExpr):
            name = agg_out.get((n.func, repr(n.arg), n.distinct))
            if name is None:
                raise ValueError(f"HAVING aggregate {n!r} must also appear "
                                 f"in the SELECT list")
            return Col(name)
        if isinstance(n, Col):
            name = visible_to_src.get(n.name, n.name)
            if name not in available:
                raise ValueError(
                    f"HAVING references {n.name!r}, which is not a GROUP BY "
                    f"column or aggregate output; available: "
                    f"{', '.join(sorted(available))}")
            return Col(name)
        return None

    return rewrite_expr(e, resolve)


def _contains_agg(e) -> bool:
    if isinstance(e, _AggExpr):
        return True
    if isinstance(e, Expr):
        return any(_contains_agg(c) for c in e.children())
    return False


def _auto_name(e: Expr) -> str:
    if isinstance(e, Col):
        return e.name
    if isinstance(e, _AggExpr):
        base = e.arg.columns()[0] if (e.arg is not None and e.arg.columns()) else "star"
        return f"{e.func.value}_{base}"
    return re.sub(r"\W+", "_", repr(e)).strip("_")[:32] or "expr"


def parse(sql: str):
    return Parser(sql).parse()
