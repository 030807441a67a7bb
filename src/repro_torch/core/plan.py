"""Logical query plans and rule-based optimization (paper §2.4).

Shark parses HiveQL into an AST, builds a logical plan, applies basic logical
optimization (predicate pushdown), then — unlike Hive, which emits MapReduce
stages — applies additional rule-based optimizations (e.g. pushing LIMIT down
to individual partitions) and emits a physical plan of RDD transformations.

We reproduce that pipeline: `optimize()` runs predicate pushdown, filter
merging, column pruning, and limit pushdown; `physical.compile_plan` then
turns the tree into an RDD lineage graph whose shuffle boundaries are the PDE
re-optimization points.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Dict, List, Optional, Sequence, Tuple

from .expr import (And, Col, Expr, Func, Lit, conjoin, infer_dtype,
                   split_conjuncts)
from .types import DType, Field, Schema


class AggFunc(enum.Enum):
    SUM = "sum"
    COUNT = "count"
    AVG = "avg"
    MIN = "min"
    MAX = "max"
    COUNT_DISTINCT = "count_distinct"


@dataclasses.dataclass(eq=False)
class AggSpec:
    out_name: str
    func: AggFunc
    arg: Optional[Expr]  # None for COUNT(*)

    def __repr__(self):
        a = "*" if self.arg is None else repr(self.arg)
        return f"{self.func.value}({a}) AS {self.out_name}"


class Node:
    def children(self) -> Sequence["Node"]:
        return ()

    def schema(self, catalog) -> Schema:
        raise NotImplementedError


@dataclasses.dataclass(eq=False)
class ScanNode(Node):
    table: str

    def schema(self, catalog) -> Schema:
        return catalog.get(self.table).schema

    def __repr__(self): return f"Scan({self.table})"


@dataclasses.dataclass(eq=False)
class FilterNode(Node):
    child: Node
    pred: Expr

    def children(self): return (self.child,)
    def schema(self, catalog): return self.child.schema(catalog)
    def __repr__(self): return f"Filter({self.pred})"


@dataclasses.dataclass(eq=False)
class ProjectNode(Node):
    child: Node
    exprs: List[Tuple[str, Expr]]  # (output name, expression)

    def children(self): return (self.child,)

    def schema(self, catalog) -> Schema:
        base = self.child.schema(catalog)
        return Schema(tuple(Field(n, infer_dtype(e, base)) for n, e in self.exprs))

    def __repr__(self):
        return "Project(" + ", ".join(f"{e} AS {n}" for n, e in self.exprs) + ")"


@dataclasses.dataclass(eq=False)
class AggregateNode(Node):
    child: Node
    group_by: List[str]          # column names (pre-projected if exprs)
    aggs: List[AggSpec]

    def children(self): return (self.child,)

    def schema(self, catalog) -> Schema:
        base = self.child.schema(catalog)
        fields = [base.field(g) for g in self.group_by]
        for a in self.aggs:
            if a.func == AggFunc.COUNT or a.func == AggFunc.COUNT_DISTINCT:
                dt = DType.INT64
            elif a.func == AggFunc.AVG:
                dt = DType.FLOAT64
            elif a.arg is not None:
                dt = infer_dtype(a.arg, base)
                if a.func == AggFunc.SUM and dt in (DType.INT32,):
                    dt = DType.INT64
            else:
                dt = DType.INT64
            fields.append(Field(a.out_name, dt))
        return Schema(tuple(fields))

    def __repr__(self):
        return f"Aggregate(by={self.group_by}, aggs={self.aggs})"


class JoinStrategy(enum.Enum):
    AUTO = "auto"            # decided at run time by PDE (§3.1.1)
    SHUFFLE = "shuffle"
    BROADCAST = "broadcast"  # map join
    COPARTITION = "copartition"


@dataclasses.dataclass(eq=False)
class JoinNode(Node):
    left: Node
    right: Node
    left_key: str
    right_key: str
    how: str = "inner"
    strategy: JoinStrategy = JoinStrategy.AUTO

    def children(self): return (self.left, self.right)

    def schema(self, catalog) -> Schema:
        return self.left.schema(catalog).concat(self.right.schema(catalog))

    def __repr__(self):
        return (f"Join({self.left_key}={self.right_key}, {self.how}, "
                f"{self.strategy.value})")


@dataclasses.dataclass(eq=False)
class SortNode(Node):
    child: Node
    keys: List[Tuple[str, bool]]  # (column, descending)

    def children(self): return (self.child,)
    def schema(self, catalog): return self.child.schema(catalog)
    def __repr__(self): return f"Sort({self.keys})"


@dataclasses.dataclass(eq=False)
class LimitNode(Node):
    child: Node
    n: int
    # set by the optimizer: per-partition pre-limit pushed below the collect
    pushed: bool = False

    def children(self): return (self.child,)
    def schema(self, catalog): return self.child.schema(catalog)
    def __repr__(self): return f"Limit({self.n}, pushed={self.pushed})"


# ---------------------------------------------------------------------------
# Rule-based optimizer
# ---------------------------------------------------------------------------


def optimize(node: Node, catalog) -> Node:
    node = push_down_filters(node, catalog)
    node = merge_filters(node)
    node = order_joins(node, catalog)
    node = push_down_limits(node)
    return node


def _substitute(e: Expr, mapping: Dict[str, Expr]) -> Expr:
    """Rewrite column refs through a projection (for pushdown)."""
    from .expr import rewrite_expr
    return rewrite_expr(
        e, lambda n: mapping.get(n.name, n) if isinstance(n, Col) else None)


def push_down_filters(node: Node, catalog=None) -> Node:
    """Predicate pushdown: move filters below projects and into join sides.

    With a catalog, scan schemas resolve exactly, so WHERE conjuncts of an
    N-way join descend all the way onto the individual scans — which is what
    feeds map pruning (§3.5) and the "likely small side" prior (§6.3.2).
    Pushing into the non-preserved side of an outer join is unsound (it
    would turn NULL-padded rows into dropped rows), so only the preserved
    left side receives pushdowns there."""
    if isinstance(node, FilterNode):
        child = node.child
        if isinstance(child, ProjectNode):
            mapping = {n: e for n, e in child.exprs}
            # only push if every referenced output column maps to a pure expr
            if all(c in mapping for c in node.pred.columns()):
                new_pred = _substitute(node.pred, mapping)
                return push_down_filters(
                    ProjectNode(FilterNode(child.child, new_pred),
                                child.exprs), catalog)
        if isinstance(child, FilterNode):
            merged = FilterNode(child.child, And(child.pred, node.pred))
            return push_down_filters(merged, catalog)
        if isinstance(child, JoinNode):
            l_schema_cols = set(_available_columns(child.left, catalog))
            r_schema_cols = set(_available_columns(child.right, catalog))
            keep, left_preds, right_preds = [], [], []
            for c in split_conjuncts(node.pred):
                cols = set(c.columns())
                if cols <= l_schema_cols:
                    left_preds.append(c)
                elif cols <= r_schema_cols and child.how == "inner":
                    right_preds.append(c)
                else:
                    keep.append(c)
            new_left = child.left
            new_right = child.right
            if left_preds:
                new_left = FilterNode(new_left, conjoin(left_preds))
            if right_preds:
                new_right = FilterNode(new_right, conjoin(right_preds))
            new_join = JoinNode(push_down_filters(new_left, catalog),
                                push_down_filters(new_right, catalog),
                                child.left_key, child.right_key, child.how,
                                child.strategy)
            if keep:
                return FilterNode(new_join, conjoin(keep))
            return new_join
        return FilterNode(push_down_filters(child, catalog), node.pred)
    # generic recursion
    for attr in ("child", "left", "right"):
        if hasattr(node, attr):
            setattr(node, attr, push_down_filters(getattr(node, attr),
                                                  catalog))
    return node


def _available_columns(node: Node, catalog=None) -> List[str]:
    if isinstance(node, ScanNode):
        if catalog is not None:
            try:
                return list(catalog.schema(node.table).names)
            except KeyError:
                pass
        return ["*"]  # unknown without catalog; "*" matches nothing
    if isinstance(node, ProjectNode):
        return [n for n, _ in node.exprs]
    if isinstance(node, AggregateNode):
        return node.group_by + [a.out_name for a in node.aggs]
    cols: List[str] = []
    for ch in node.children():
        cols.extend(_available_columns(ch, catalog))
    return cols


def merge_filters(node: Node) -> Node:
    if isinstance(node, FilterNode) and isinstance(node.child, FilterNode):
        return merge_filters(
            FilterNode(node.child.child, And(node.child.pred, node.pred)))
    for attr in ("child", "left", "right"):
        if hasattr(node, attr):
            setattr(node, attr, merge_filters(getattr(node, attr)))
    return node


def push_down_limits(node: Node) -> Node:
    """Paper §2.4: push LIMIT down to individual partitions.  Each partition
    task emits at most n rows; the collect stage applies the final limit."""
    if isinstance(node, LimitNode):
        child = node.child
        if isinstance(child, (ScanNode, FilterNode, ProjectNode)):
            node.pushed = True
    for attr in ("child", "left", "right"):
        if hasattr(node, attr):
            setattr(node, attr, push_down_limits(getattr(node, attr)))
    return node


# ---------------------------------------------------------------------------
# Cost-based join ordering (left-deep, smallest-relation-first with
# co-partition awareness).  PDE then re-plans every boundary at run time from
# observed map-output sizes — this pass only picks the *initial* shape.
# ---------------------------------------------------------------------------

def _broadcast_prior_bytes() -> float:
    """The default PDE broadcast threshold, as the static prior for 'this
    side is probably cheap to move'.  The runtime decision uses observed
    sizes against the session's actual PDEConfig; the ordering pass only
    needs the right order of magnitude."""
    from .pde import PDEConfig
    return PDEConfig().broadcast_threshold_bytes


def estimate_relation(node: Node, catalog) -> "RelEstimate":
    """Pre-execution (rows, bytes) estimate of a plan subtree, from catalog
    and piggybacked partition statistics (core/stats.py)."""
    from .stats import (RelEstimate, predicate_selectivity,
                        surviving_partition_fraction)
    if isinstance(node, ScanNode):
        t = catalog.get(node.table)
        return RelEstimate(float(t.num_rows), float(t.nbytes), t)
    if isinstance(node, FilterNode):
        base = estimate_relation(node.child, catalog)
        sel = predicate_selectivity(node.pred)
        if base.table is not None:
            # partition-stat refutation gives a hard upper bound on survivors
            sel = min(sel, surviving_partition_fraction(base.table, node.pred))
        return dataclasses.replace(base, rows=base.rows * sel,
                                   nbytes=base.nbytes * sel)
    if isinstance(node, ProjectNode):
        base = estimate_relation(node.child, catalog)
        return dataclasses.replace(base, table=None)
    if isinstance(node, LimitNode):
        base = estimate_relation(node.child, catalog)
        rows = min(base.rows, float(node.n))
        frac = rows / base.rows if base.rows > 0 else 1.0
        return dataclasses.replace(base, rows=rows, nbytes=base.nbytes * frac,
                                   table=None)
    if isinstance(node, AggregateNode):
        base = estimate_relation(node.child, catalog)
        rows = max(1.0, base.rows ** 0.5)  # grouping collapses cardinality
        return dataclasses.replace(base, rows=rows,
                                   nbytes=base.nbytes * rows / max(base.rows, 1.0),
                                   table=None)
    if isinstance(node, JoinNode):
        return _estimate_join(node, catalog)[0]
    if isinstance(node, SortNode):
        base = estimate_relation(node.child, catalog)
        return dataclasses.replace(base, table=None)
    # unknown node: sum children
    rows = nbytes = 0.0
    for ch in node.children():
        e = estimate_relation(ch, catalog)
        rows += e.rows
        nbytes += e.nbytes
    return RelEstimate(rows, nbytes)


def _join_key_ndv(est, key: str) -> float:
    """Distinct-value estimate of a join key within one relation."""
    from .stats import table_column_ndv
    if est.table is not None:
        ndv = table_column_ndv(est.table, key)
        if ndv is not None:
            return float(max(ndv, 1))
    return max(est.rows, 1.0)


def _estimate_join(node: "JoinNode", catalog):
    """(output RelEstimate, boundary cost in bytes moved) for one join."""
    from .stats import RelEstimate
    l = estimate_relation(node.left, catalog)
    r = estimate_relation(node.right, catalog)
    ndv = max(_join_key_ndv(l, node.left_key), _join_key_ndv(r, node.right_key))
    out_rows = max(1.0, l.rows * r.rows / ndv)
    out_bytes = out_rows * (l.bytes_per_row + r.bytes_per_row)
    cost = _boundary_cost(node, l, r)
    return RelEstimate(out_rows, out_bytes), cost


def _boundary_cost(node: "JoinNode", l, r) -> float:
    """Estimated bytes moved across this shuffle boundary under the runtime
    strategies PDE can pick: zip (co-partitioned) ≈ 0, broadcast = small
    side only, shuffle = both sides."""
    if (l.table is not None and r.table is not None
            and l.table.co_partitioned_with(r.table, node.left_key,
                                            node.right_key)):
        return 0.0
    small = min(l.nbytes, r.nbytes)
    if small <= _broadcast_prior_bytes():
        return small
    return l.nbytes + r.nbytes


def estimate_plan_cost(node: Node, catalog) -> float:
    """Total estimated bytes moved across all join boundaries of a plan —
    the objective the join-ordering pass minimizes (and what the property
    test compares across join orders)."""
    total = 0.0
    if isinstance(node, JoinNode):
        _, cost = _estimate_join(node, catalog)
        total += cost
    for ch in node.children():
        total += estimate_plan_cost(ch, catalog)
    return total


def _flatten_join_chain(node: Node):
    """Flatten a tree of inner AUTO joins into (relations, edges); each edge
    is (left_key, right_key) from one JoinNode.  Non-join subtrees (scans,
    filtered scans, aggregates, outer joins, forced strategies) stay opaque
    relations."""
    rels: List[Node] = []
    edges: List[Tuple[str, str]] = []

    def walk(n: Node):
        if (isinstance(n, JoinNode) and n.how == "inner"
                and n.strategy == JoinStrategy.AUTO):
            walk(n.left)
            walk(n.right)
            edges.append((n.left_key, n.right_key))
        else:
            rels.append(n)

    walk(node)
    return rels, edges


def order_joins(node: Node, catalog) -> Node:
    """Cost-based initial join ordering: rebuild chains of ≥3 inner-joined
    relations as a left-deep tree, greedily attaching the cheapest next
    relation (smallest estimated size; co-partitioned pairs first since
    they join shuffle-free, §3.4).

    Conservative by design: bails out (returning the tree unchanged) on
    outer joins, planner-forced strategies, ambiguous key ownership, or
    duplicate column names across relations — the runtime PDE still
    re-optimizes every boundary of an un-reordered plan."""
    if isinstance(node, JoinNode):
        reordered = _try_reorder(node, catalog)
        if reordered is not None:
            # _try_reorder already ordered each opaque relation's subtree;
            # recursing into the freshly built spine would only re-derive it
            return reordered
    for attr in ("child", "left", "right"):
        if hasattr(node, attr):
            setattr(node, attr, order_joins(getattr(node, attr), catalog))
    return node


def _try_reorder(root: "JoinNode", catalog) -> Optional[Node]:
    rels, edges = _flatten_join_chain(root)
    if len(rels) < 3 or len(edges) != len(rels) - 1:
        return None
    # order any nested join chains inside the opaque relations now — the
    # caller will not descend into a successfully rebuilt spine
    rels = [order_joins(r, catalog) for r in rels]
    # schemas + global column uniqueness (join output flattens columns with
    # positional _r suffixing — reordering under duplicates would rename)
    schemas: List[set] = []
    seen: set = set()
    for r in rels:
        try:
            names = set(r.schema(catalog).names)
        except Exception:
            return None
        if seen & names:
            return None
        seen |= names
        schemas.append(names)

    def owner(col: str) -> Optional[int]:
        hits = [i for i, s in enumerate(schemas) if col in s]
        return hits[0] if len(hits) == 1 else None

    adj: Dict[int, List[Tuple[int, str, str]]] = {i: [] for i in range(len(rels))}
    for lk, rk in edges:
        a, b = owner(lk), owner(rk)
        if a is None or b is None or a == b:
            return None
        adj[a].append((b, lk, rk))
        adj[b].append((a, rk, lk))

    ests = [estimate_relation(r, catalog) for r in rels]

    def attach_cost(tree_est, cand_est, tree_is_scan_pair=None) -> float:
        if tree_is_scan_pair is not None:
            lk, rk = tree_is_scan_pair
            if (tree_est.table is not None and cand_est.table is not None
                    and tree_est.table.co_partitioned_with(
                        cand_est.table, lk, rk)):
                return 0.0
        small = min(tree_est.nbytes, cand_est.nbytes)
        if small <= _broadcast_prior_bytes():
            return small
        return tree_est.nbytes + cand_est.nbytes

    # start: the connected pair with the cheapest first boundary, breaking
    # ties toward smaller combined size (smallest-relation-first)
    best = None
    for a in range(len(rels)):
        for b, lk, rk in adj[a]:
            if a >= b:
                continue
            cost = attach_cost(ests[a], ests[b], (lk, rk))
            key = (cost, ests[a].nbytes + ests[b].nbytes, a, b)
            if best is None or key < best[0]:
                best = (key, a, b, lk, rk)
    if best is None:
        return None
    _, a, b, lk, rk = best
    # the smaller relation leads (build side of the first boundary)
    if ests[b].nbytes < ests[a].nbytes:
        a, b, lk, rk = b, a, rk, lk

    placed = {a, b}
    tree: Node = JoinNode(rels[a], rels[b], lk, rk, "inner")
    tree_est, _ = _estimate_join(tree, catalog)
    while len(placed) < len(rels):
        cand = None
        for p in placed:
            for q, pk, qk in adj[p]:
                if q in placed:
                    continue
                cost = attach_cost(tree_est, ests[q])
                key = (cost, ests[q].nbytes, q)
                if cand is None or key < cand[0]:
                    cand = (key, q, pk, qk)
        if cand is None:
            return None  # disconnected (cross join): keep original order
        _, q, pk, qk = cand
        tree = JoinNode(tree, rels[q], pk, qk, "inner")
        tree_est, _ = _estimate_join(tree, catalog)
        placed.add(q)
    return tree


def required_columns(node: Node, catalog, want: Optional[set] = None) -> Dict[str, set]:
    """Column pruning analysis: per base table, which columns are needed.
    The physical scan only decodes these blocks (columnar advantage)."""
    out: Dict[str, set] = {}

    def walk(n: Node, needed: Optional[set]):
        if isinstance(n, ScanNode):
            schema = n.schema(catalog)
            cols = set(schema.names) if needed is None else (needed & set(schema.names))
            out.setdefault(n.table, set()).update(cols)
            return
        if isinstance(n, FilterNode):
            sub = None if needed is None else needed | set(n.pred.columns())
            walk(n.child, sub)
            return
        if isinstance(n, ProjectNode):
            sub: set = set()
            for name, e in n.exprs:
                if needed is None or name in needed:
                    sub.update(e.columns())
            walk(n.child, sub)
            return
        if isinstance(n, AggregateNode):
            sub = set(n.group_by)
            for a in n.aggs:
                if a.arg is not None:
                    sub.update(a.arg.columns())
            walk(n.child, sub)
            return
        if isinstance(n, JoinNode):
            lcols = set(_schema_names_safe(n.left, catalog))
            rcols = set(_schema_names_safe(n.right, catalog))
            need = needed
            lneed = None if need is None else ((need & lcols) | {n.left_key})
            rneed = None if need is None else ((need & rcols) | {n.right_key})
            walk(n.left, lneed)
            walk(n.right, rneed)
            return
        if isinstance(n, SortNode):
            sub = None if needed is None else needed | {k for k, _ in n.keys}
            walk(n.child, sub)
            return
        for ch in n.children():
            walk(ch, needed)

    walk(node, want)
    return out


def _schema_names_safe(node: Node, catalog) -> Tuple[str, ...]:
    try:
        return node.schema(catalog).names
    except Exception:
        return ()


# ---------------------------------------------------------------------------
# Pipeline segmentation (paper §2.4 narrow-chain pipelining + §5 compiled
# evaluators).  A *physical-layer* pass: the logical plan, explain() output
# and plan fingerprints are untouched — segmentation only describes how the
# executor will run a maximal scan→filter→project chain, namely as ONE
# compiled columnar function per partition instead of one interpreted
# operator at a time.  Filters and projections are folded into scan-column
# terms by substituting column references through intervening projections
# (the same rewrite predicate pushdown uses), so the segment is fully
# described by (scan, one conjunctive predicate, one output projection).
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PipelineSegment:
    """One maximal narrow chain over a scan, in scan-column terms."""
    scan: ScanNode
    pred: Optional[Expr]                        # conjunction, or None
    exprs: Optional[List[Tuple[str, Expr]]]     # None = all scan columns
    depth: int = 0                              # logical operators folded

    def output_names(self, catalog) -> List[str]:
        if self.exprs is None:
            return list(self.scan.schema(catalog).names)
        return [n for n, _ in self.exprs]


def fold_pipeline(node: Node) -> Optional[PipelineSegment]:
    """Fold a scan→filter→project chain into a PipelineSegment, or None if
    `node` is not such a chain (joins, aggregates, sorts, limits and other
    blocking/wide operators terminate the chain)."""
    if isinstance(node, ScanNode):
        return PipelineSegment(node, None, None, 0)
    if isinstance(node, FilterNode):
        seg = fold_pipeline(node.child)
        if seg is None:
            return None
        pred = node.pred
        if seg.exprs is not None:
            mapping = {n: e for n, e in seg.exprs}
            if not all(c in mapping for c in pred.columns()):
                return None
            pred = _substitute(pred, mapping)
        merged = pred if seg.pred is None else And(seg.pred, pred)
        return dataclasses.replace(seg, pred=merged, depth=seg.depth + 1)
    if isinstance(node, ProjectNode):
        seg = fold_pipeline(node.child)
        if seg is None:
            return None
        if seg.exprs is None:
            exprs = list(node.exprs)
        else:
            mapping = {n: e for n, e in seg.exprs}
            if not all(c in mapping
                       for _, e in node.exprs for c in e.columns()):
                return None
            exprs = [(n, _substitute(e, mapping)) for n, e in node.exprs]
        return dataclasses.replace(seg, exprs=exprs, depth=seg.depth + 1)
    return None


# ---------------------------------------------------------------------------
# Whole-stage programs (DESIGN.md §14).  One step past PipelineSegment: the
# entire MAP STAGE of a blocking operator — the narrow segment chained into
# its consumer's map-side work (partial aggregation, per-partition top-k, or
# the pushed-down limit) and into the exchange's radix bucketing — described
# as one unit so the executor can run it as ONE program per partition
# with no host seam before the shuffle.  Still physical-layer only: the
# logical plan, explain() and plan fingerprints never see stage folding.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class StageProgram:
    """One whole map stage: a PipelineSegment plus the blocking consumer
    whose map-side work fuses behind it."""
    segment: PipelineSegment
    consumer: str                               # aggregate | sort | limit
    group_cols: List[str] = dataclasses.field(default_factory=list)
    aggs: List["AggSpec"] = dataclasses.field(default_factory=list)
    sort_keys: List[Tuple[str, bool]] = dataclasses.field(
        default_factory=list)
    limit: Optional[int] = None


def fold_stage(node: Node) -> Optional[StageProgram]:
    """Fold a blocking operator over a narrow chain into a StageProgram, or
    None when the operator's input is not a foldable scan chain (joins and
    other wide inputs keep the segment-at-a-time path)."""
    if isinstance(node, AggregateNode):
        seg = fold_pipeline(node.child)
        if seg is None:
            return None
        return StageProgram(seg, "aggregate", list(node.group_by),
                            list(node.aggs))
    if isinstance(node, SortNode):
        seg = fold_pipeline(node.child)
        if seg is None:
            return None
        return StageProgram(seg, "sort", sort_keys=list(node.keys))
    if isinstance(node, LimitNode):
        if isinstance(node.child, SortNode):
            prog = fold_stage(node.child)
            if prog is None:
                return None
            return dataclasses.replace(prog, limit=node.n)
        seg = fold_pipeline(node.child)
        if seg is None:
            return None
        return StageProgram(seg, "limit", limit=node.n)
    return None


def explain(node: Node, indent: int = 0) -> str:
    pad = "  " * indent
    lines = [pad + repr(node)]
    for ch in node.children():
        lines.append(explain(ch, indent + 1))
    return "\n".join(lines)


def plan_tables(node: Node) -> List[str]:
    """Base tables a plan reads, sorted and de-duplicated."""
    out = set()

    def walk(n: Node):
        if isinstance(n, ScanNode):
            out.add(n.table)
        for ch in n.children():
            walk(ch)

    walk(node)
    return sorted(out)


def plan_fingerprint(node: Node, catalog) -> Tuple[str, Dict[str, int]]:
    """(fingerprint, {table: version}) for an *optimized* plan: sha1 of
    explain(plan) and the catalog version of every table it reads — the
    key of the server tier's result cache (DESIGN.md §6.4), kept here
    until that tier is ported."""
    import hashlib
    deps = {t: catalog.version(t) for t in plan_tables(node)}
    text = explain(node) + "|" + ",".join(
        f"{t}@{v}" for t, v in sorted(deps.items()))
    return hashlib.sha1(text.encode()).hexdigest(), deps
