"""SharkFrame — the lazy, composable query surface (DESIGN.md §7).

The paper's headline claim (§4.1) is that SQL and iterative ML share one
engine, one lineage graph, and one memory store.  SharkFrame makes that
composition first-class: a frame is an immutable handle on a logical `Node`
tree — the *same* trees the SQL binder emits — built fluently:

    top = (sess.table("rankings")
               .filter(col("pageRank") > 100)
               .join(sess.table("uservisits"), on=("pageURL", "destURL"))
               .group_by(col("destURL"))
               .agg(sum_(col("adRevenue")).alias("rev"))
               .order_by("rev", desc=True)
               .limit(10))
    top.to_numpy()

Because both surfaces share `bind_aggregate` (core/sql.py) and the same
rule-based `optimize()`, a frame query and its SQL-text twin optimize to
byte-identical plans: one `plan_fingerprint`, one server result-cache
entry, the same PDE re-optimization points.  Terminal actions:

    .collect()    -> ExecResult (admission-controlled + fair-scheduled when
                     the session is attached to a SharkServer: the bound
                     plan itself is submitted, not query text)
    .to_numpy()   -> dict of column arrays
    .to_rdd()     -> the plan as a lazy TableRDD (Listing 1's escape hatch;
                     shuffle outputs are registered with the session for
                     release via release_shuffles())
    .to_features()-> dense feature-matrix RDD for ml/ (one lineage graph)
    .cache(name)  -> materialize + register as a table (CTAS equivalent)
    .explain()    -> optimized-plan string

Every constructor validates eagerly against the catalog schema and raises
`FrameBindError` naming the frame operation and the offending column —
never a raw binder KeyError.
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .expr import Aliased, BinOp, Col, Expr, Lit, rewrite_expr
from .plan import (AggFunc, AggregateNode, FilterNode, JoinNode, LimitNode,
                   Node, ProjectNode, ScanNode, SortNode,
                   explain as explain_plan, optimize)
from .sql import _AggExpr, _auto_name, _contains_agg, bind_aggregate
from .types import Schema

__all__ = ["SharkFrame", "GroupedFrame", "FrameBindError"]


class FrameBindError(ValueError):
    """A frame operation referenced a column or table that does not exist
    (raised eagerly, at construction — not at execution)."""


def _unalias(item) -> Tuple[Optional[str], Expr]:
    """(alias-or-None, expr) from an Expr, Aliased, or bare column name."""
    if isinstance(item, Aliased):
        return item.name, item.expr
    if isinstance(item, str):
        return None, Col(item)
    if isinstance(item, Expr):
        return None, item
    raise TypeError(f"expected a column name, Expr, or .alias()ed Expr; "
                    f"got {type(item).__name__}")


class SharkFrame:
    """Immutable lazy relational query; every operator returns a new frame
    over an extended logical plan.  See the module docstring."""

    def __init__(self, session, node: Node, result=None):
        self._session = session
        self._node = node
        self._result = result          # memoized ExecResult
        self._schema: Optional[Schema] = None

    # -- construction -------------------------------------------------------

    @classmethod
    def table(cls, session, name: str) -> "SharkFrame":
        if not session.catalog.exists(name):
            known = sorted(session.catalog.tables())
            raise FrameBindError(
                f"SharkSession.table(): unknown table {name!r}"
                + (f"; known tables: {', '.join(known)}" if known else ""))
        return cls(session, ScanNode(name))

    def _derive(self, node: Node) -> "SharkFrame":
        return SharkFrame(self._session, node)

    # -- schema -------------------------------------------------------------

    @property
    def schema(self) -> Schema:
        if self._schema is None:
            self._schema = self._node.schema(self._session.catalog)
        return self._schema

    @property
    def columns(self) -> List[str]:
        return list(self.schema.names)

    def _check_columns(self, cols: Sequence[str], op: str) -> None:
        avail = self.columns
        for c in cols:
            if c not in avail:
                raise FrameBindError(
                    f"SharkFrame.{op}(): unknown column {c!r}; "
                    f"available columns: {', '.join(avail)}")

    # -- relational operators -----------------------------------------------

    def filter(self, pred: Expr) -> "SharkFrame":
        if not isinstance(pred, Expr):
            raise TypeError("SharkFrame.filter() takes an Expr predicate, "
                            "e.g. col('pageRank') > 100")
        if _contains_agg(pred):
            raise FrameBindError(
                "SharkFrame.filter(): predicate contains an aggregate — "
                "filter aggregated output with .having() after .agg()")
        self._check_columns(pred.columns(), "filter")
        return self._derive(FilterNode(self._node, pred))

    where = filter

    def select(self, *items) -> "SharkFrame":
        if not items:
            raise ValueError("SharkFrame.select() needs at least one column")
        pairs = [_unalias(i) for i in items]
        for _, e in pairs:
            self._check_columns(e.columns(), "select")
        if any(_contains_agg(e) for _, e in pairs):
            for _, e in pairs:
                if _contains_agg(e) and not isinstance(e, _AggExpr):
                    raise FrameBindError(
                        f"SharkFrame.select(): aggregate calls must be "
                        f"top-level, not nested inside {e!r}; aggregate "
                        f"first (e.g. .agg(sum_(col('x')).alias('s'))), "
                        f"then compute over the output")
            # global aggregate: SELECT COUNT(*), SUM(x) FROM ...
            return self._bind_agg(pairs, group_items=[], op="select")
        exprs = [(alias or _auto_name(e), e) for alias, e in pairs]
        return self._derive(ProjectNode(self._node, exprs))

    def join(self, other: Union["SharkFrame", str], on,
             how: str = "inner") -> "SharkFrame":
        """Equi-join with another frame (or table name).  Chained
        `.join().join()` calls build the same left-deep JoinNode trees the
        SQL binder emits for `FROM a JOIN b ON ... JOIN c ON ...`, so an
        N-way frame query and its SQL twin optimize — including the
        cost-based join-ordering pass — to byte-identical plans: one
        `plan_fingerprint`, one result-cache entry, and the same PDE
        re-optimization points at every join boundary."""
        if isinstance(other, str):
            other = SharkFrame.table(self._session, other)
        if other._session.catalog is not self._session.catalog:
            raise FrameBindError("SharkFrame.join(): frames belong to "
                                 "different catalogs")
        if how not in ("inner", "left"):
            raise FrameBindError(f"SharkFrame.join(): unsupported how={how!r} "
                                 "(inner or left)")
        lk, rk = self._join_keys(other, on)
        self._check_columns([lk], "join")
        other._check_columns([rk], "join")
        return self._derive(JoinNode(self._node, other._node, lk, rk, how))

    def _join_keys(self, other: "SharkFrame", on) -> Tuple[str, str]:
        from .expr import Cmp
        if isinstance(on, str):
            return on, on
        if isinstance(on, Col):
            return on.name, on.name
        if isinstance(on, (tuple, list)) and len(on) == 2:
            l, r = on
            lk = l.name if isinstance(l, Col) else l
            rk = r.name if isinstance(r, Col) else r
            return lk, rk
        if isinstance(on, Cmp) and on.op == "=" and \
                isinstance(on.left, Col) and isinstance(on.right, Col):
            lk, rk = on.left.name, on.right.name
            if lk not in self.columns and rk in self.columns:
                lk, rk = rk, lk  # user wrote the sides swapped
            return lk, rk
        raise FrameBindError(
            "SharkFrame.join(): `on` must be a column name, a "
            "(left_key, right_key) pair, or an equality like "
            "col('pageURL') == col('destURL')")

    def group_by(self, *keys) -> "GroupedFrame":
        if not keys:
            raise ValueError("SharkFrame.group_by() needs at least one key")
        pairs = [_unalias(k) for k in keys]
        for _, e in pairs:
            if _contains_agg(e):
                raise FrameBindError("SharkFrame.group_by(): cannot group by "
                                     "an aggregate")
            self._check_columns(e.columns(), "group_by")
        return GroupedFrame(self, pairs)

    def agg(self, *aggs) -> "SharkFrame":
        """Global aggregation (no grouping): frame.agg(count().alias('n'))."""
        return GroupedFrame(self, []).agg(*aggs)

    def having(self, pred: Expr) -> "SharkFrame":
        agg = self._agg_output()
        if agg is None:
            raise FrameBindError(
                "SharkFrame.having(): no preceding aggregation — call "
                ".group_by(...).agg(...) first (or use .filter())")
        pred = self._resolve_having_aggs(pred, agg)
        self._check_columns(pred.columns(), "having")
        return self._derive(FilterNode(self._node, pred))

    def _agg_output(self) -> Optional[AggregateNode]:
        """The AggregateNode whose output this frame exposes (through any
        stack of post-project / filter / sort / limit), else None.  Computed
        from the plan itself so SQL-built frames (`sess.sql(...)`) support
        `.having()` exactly like fluent ones."""
        node = self._node
        while isinstance(node, (ProjectNode, FilterNode, SortNode,
                                LimitNode)):
            if isinstance(node, ProjectNode) and not all(
                    isinstance(e, Col) for _, e in node.exprs):
                return None  # computed projection: agg outputs not addressable
            node = node.child
        return node if isinstance(node, AggregateNode) else None

    def _resolve_having_aggs(self, pred: Expr, agg: AggregateNode) -> Expr:
        """Rewrite aggregate calls in a having predicate to the output
        column of the matching AggSpec (mirroring SQL HAVING's resolution),
        so `.having(count() > 5)` works like `HAVING COUNT(*) > 5`."""
        out_name: Dict[Tuple, str] = {}
        for spec in agg.aggs:
            if spec.func == AggFunc.COUNT_DISTINCT:
                key = (AggFunc.COUNT, repr(spec.arg), True)
            else:
                key = (spec.func, repr(spec.arg), False)
            out_name.setdefault(key, spec.out_name)
        visible = set(self.columns)

        def resolve(e):
            if isinstance(e, _AggExpr):
                name = out_name.get((e.func, repr(e.arg), e.distinct))
                if name is None or name not in visible:
                    raise FrameBindError(
                        f"SharkFrame.having(): aggregate {e!r} is not in "
                        f"this frame's .agg() output; available columns: "
                        f"{', '.join(self.columns)}")
                return Col(name)
            return None

        return rewrite_expr(pred, resolve)

    def order_by(self, *keys, desc: bool = False) -> "SharkFrame":
        out: List[Tuple[str, bool]] = []
        for k in keys:
            if isinstance(k, tuple):
                name, d = k
                name = name.name if isinstance(name, Col) else name
                out.append((name, bool(d)))
            elif isinstance(k, Col):
                out.append((k.name, desc))
            else:
                out.append((k, desc))
        self._check_columns([n for n, _ in out], "order_by")
        return self._derive(SortNode(self._node, out))

    def limit(self, n: int) -> "SharkFrame":
        return self._derive(LimitNode(self._node, int(n)))

    def similarity_join(self, embedding: str, query, k: int,
                        score_col: str = "score") -> "SharkFrame":
        """Top-k dot-product similarity search against an embedding's lane
        columns (DESIGN.md §15.3): every surviving row gets
        `score = sum(lane_i * query_i)` and the k highest-scoring rows win
        (ties by physical row order, both execution paths).

        Lowers to ordinary relational nodes —
        Limit(k, Sort(score desc, Project(*, score))) — which is exactly
        the plan of the SQL twin `SELECT *, f_0*q_0 + f_1*q_1 + ... AS
        score FROM ... ORDER BY score DESC LIMIT k`, so filters written
        before the call push below the score projection and prune
        partitions as usual, and the physical layer may route eligible
        partitions to the `topk_similarity` kernel route
        (`physical._match_topk`), which the port does not have yet.  `embedding` resolves through the
        catalog's `Table.embeddings` lane mapping, or by `{embedding}_{i}`
        prefix over this frame's columns."""
        q = np.asarray(query, dtype=np.float64).ravel()
        lanes = self._embedding_lanes(embedding)
        if not lanes:
            raise FrameBindError(
                f"SharkFrame.similarity_join(): no embedding {embedding!r} "
                f"— expected catalog lane metadata or consecutive "
                f"'{embedding}_0', '{embedding}_1', ... columns; available "
                f"columns: {', '.join(self.columns)}")
        if len(q) != len(lanes):
            raise FrameBindError(
                f"SharkFrame.similarity_join(): query vector has {len(q)} "
                f"components but embedding {embedding!r} has {len(lanes)} "
                f"lanes ({lanes[0]}..{lanes[-1]})")
        if score_col in self.columns:
            raise FrameBindError(
                f"SharkFrame.similarity_join(): score column {score_col!r} "
                f"already exists; pass score_col= to rename")
        expr: Optional[Expr] = None
        for lane, w in zip(lanes, q.tolist()):
            term = BinOp("*", Col(lane), Lit(float(w)))
            expr = term if expr is None else BinOp("+", expr, term)
        proj = ProjectNode(self._node,
                           [(c, Col(c)) for c in self.columns]
                           + [(score_col, expr)])
        return self._derive(
            LimitNode(SortNode(proj, [(score_col, True)]), int(k)))

    def _embedding_lanes(self, embedding: str) -> List[str]:
        """Lane columns for `embedding`, in lane order: the source table's
        `embeddings` metadata when the lanes survive to this frame's
        output, else consecutive `{embedding}_{i}` name matching."""
        cols = set(self.columns)
        node = self._node
        while True:
            if isinstance(node, ScanNode):
                table = self._session.catalog.get(node.table)
                lanes = table.embeddings.get(embedding)
                if lanes and all(l in cols for l in lanes):
                    return list(lanes)
                break
            kids = node.children()
            if len(kids) != 1:
                break               # joins/unions: fall back to names
            node = kids[0]
        lanes = []
        while f"{embedding}_{len(lanes)}" in cols:
            lanes.append(f"{embedding}_{len(lanes)}")
        return lanes

    def _bind_agg(self, select_items, group_items, op: str) -> "SharkFrame":
        sess = self._session
        try:
            node = bind_aggregate(sess.catalog, self._node, select_items,
                                  [e for _, e in group_items])
        except ValueError as err:
            raise FrameBindError(f"SharkFrame.{op}(): {err}") from None
        return self._derive(node)

    # -- planning -----------------------------------------------------------

    def logical_plan(self) -> Node:
        """The bound (un-optimized) plan.  The tree is shared with this
        frame: optimize a deep copy, never the original."""
        return self._node

    def optimized_plan(self) -> Node:
        # optimize() rewrites in place; frames are immutable and may share
        # subtrees, so it must run on a private copy
        return optimize(copy.deepcopy(self._node), self._session.catalog)

    def explain(self) -> str:
        return explain_plan(self.optimized_plan())

    # -- terminal actions ---------------------------------------------------

    def collect(self):
        """Execute (once; memoized) and return the ExecResult."""
        if self._result is None:
            self._result = self._session.executor.execute(
                copy.deepcopy(self._node))
        return self._result

    def to_numpy(self) -> Dict[str, np.ndarray]:
        return self.collect().to_numpy()

    def count(self) -> int:
        return int(self.collect().num_rows)

    def to_rdd(self):
        """Compile to an RDD whose final narrow stage is left lazy, so
        downstream ML extends the same lineage graph (paper §4.1).  Upstream
        shuffle map outputs are recorded on the session's executor and are
        freed by `session.release_shuffles()` / `session.shutdown()` — a
        server-attached session cannot silently leak shared-store memory."""
        sess = self._session
        node = optimize(copy.deepcopy(self._node), sess.catalog)
        compiled = sess.executor._compile(node)
        return compiled.rdd

    def to_features(self, feature_cols: Sequence[str],
                    label_col: Optional[str] = None,
                    map_rows=None, dtype=None):
        """Encoded-feature RDD for ml/ (Listing 1's mapRows step,
        DESIGN.md §15.1): the ml/ tier is not ported yet."""
        raise NotImplementedError(
            "to_features: the ml/ tier is not ported yet (ROADMAP queue A, "
            "analytics)")

    def cache(self, name: str, num_partitions: Optional[int] = None,
              distribute_by: Optional[str] = None) -> "SharkFrame":
        """Materialize and register the result as table `name` (the fluent
        CREATE TABLE ... AS equivalent).  The catalog registration bumps the
        table's epoch, invalidating dependent server result-cache entries.
        Returns a frame scanning the new table."""
        if distribute_by is not None and distribute_by not in self.columns:
            raise FrameBindError(
                f"SharkFrame.cache(): distribute_by column "
                f"{distribute_by!r} not in output; available columns: "
                f"{', '.join(self.columns)}")
        from .session import register_result_as_table
        sess = self._session
        register_result_as_table(
            sess.catalog, name, self.collect(),
            num_partitions or sess.default_partitions, distribute_by)
        return SharkFrame.table(sess, name)

    # -- ExecResult back-compat shim ----------------------------------------
    # sess.sql() historically returned an ExecResult; frames expose the same
    # surface (executing on first access) so existing call sites keep working.

    @property
    def batches(self):
        return self.collect().batches

    @property
    def schema_names(self) -> List[str]:
        return self.columns

    @property
    def num_rows(self) -> int:
        return self.collect().num_rows

    def __repr__(self):
        plan = explain_plan(self._node).replace("\n", " <- ")
        return f"SharkFrame[{', '.join(self.columns)}]({plan})"


class GroupedFrame:
    """Intermediate of `SharkFrame.group_by()`: holds the grouping keys and
    waits for `.agg(...)` to complete the aggregation."""

    def __init__(self, parent: SharkFrame,
                 group_items: List[Tuple[Optional[str], Expr]]):
        self._parent = parent
        self._group_items = group_items

    def agg(self, *aggs) -> SharkFrame:
        if not aggs:
            raise ValueError("GroupedFrame.agg() needs at least one "
                             "aggregate, e.g. sum_(col('x')).alias('s')")
        pairs = [_unalias(a) for a in aggs]
        for _, e in pairs:
            if not isinstance(e, _AggExpr):
                raise FrameBindError(
                    f"GroupedFrame.agg(): {e!r} is not an aggregate; use "
                    "sum_/avg/min_/max_/count/count_distinct from "
                    "repro_torch.core.functions")
            self._parent._check_columns(e.columns(), "agg")
        # output order matches SQL: group keys first, then aggregates
        select_items = list(self._group_items) + pairs
        return self._parent._bind_agg(select_items, self._group_items,
                                      op="agg")
