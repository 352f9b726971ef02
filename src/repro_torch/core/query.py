"""Typed query AST mirroring the paper's four query types (§2.2).

Leaf filter predicates (hybrid search):
  Range(col, lo, hi)          — relational range / equality
  GeoWithin(col, rect)        — ST_Contains(col, @region)
  TextContains(col, term)     — content LIKE '%kw%' via inverted index
  VectorRange(col, q, thresh) — L2_Distance(col, q) < thresh

Boolean combinators compose leaves into a filter *expression tree*:
  And(a, b, ...) | Or(a, b, ...) | Not(a)

The planner normalizes expressions to DNF (``to_dnf``): a disjunction of
conjuncts, each conjunct a tuple of *literals* (a leaf predicate or a
``Not``-wrapped leaf).  Each conjunct is planned with the per-subset index
enumeration; conjunct bitmaps are OR-merged by the ``BitmapUnion``
physical operator.

Rank terms (hybrid NN, weighted sum — Algorithm 1's  s(o) = Σ λ_j d_j(o)):
  VectorRank(col, q, weight)
  SpatialRank(col, point, weight)
  TextRank(col, terms, weight)

HybridQuery(where, ranks, k): ranks empty => Type-1 hybrid search;
ranks non-empty => Type-2 hybrid NN. Continuous wrappers (Type 3/4) live
in core.continuous; the user-facing facade lives in core.api.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np


# ---------------------------------------------------------------------------
# leaf filter predicates
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Range:
    col: str
    lo: float
    hi: float                      # inclusive bounds


@dataclasses.dataclass(frozen=True)
class GeoWithin:
    col: str
    rect: Tuple[float, float, float, float]   # (xmin, ymin, xmax, ymax)


@dataclasses.dataclass(frozen=True)
class TextContains:
    col: str
    term: str


@dataclasses.dataclass(frozen=True, eq=False)
class VectorRange:
    """L2 distance below a threshold."""
    col: str
    q: np.ndarray
    thresh: float

    def __post_init__(self):
        object.__setattr__(self, "q", np.asarray(self.q, np.float32))
        object.__setattr__(self, "thresh", float(self.thresh))

    def __eq__(self, other):
        return (isinstance(other, VectorRange) and self.col == other.col
                and self.thresh == other.thresh
                and self.q.shape == other.q.shape
                and self.q.tobytes() == other.q.tobytes())

    def __hash__(self):
        return hash((self.col, self.q.tobytes(), self.thresh))

    def __repr__(self):
        return f"VectorRange({self.col}, dim={self.q.shape}, <{self.thresh})"


Predicate = Union[Range, GeoWithin, TextContains, VectorRange]


# ---------------------------------------------------------------------------
# boolean combinators
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, init=False)
class And:
    children: Tuple["BoolExpr", ...]

    def __init__(self, *children):
        if len(children) == 1 and isinstance(children[0], (list, tuple)):
            children = tuple(children[0])
        object.__setattr__(self, "children", tuple(children))

    def __repr__(self):
        return "And(" + ", ".join(repr(c) for c in self.children) + ")"


@dataclasses.dataclass(frozen=True, init=False)
class Or:
    children: Tuple["BoolExpr", ...]

    def __init__(self, *children):
        if len(children) == 1 and isinstance(children[0], (list, tuple)):
            children = tuple(children[0])
        object.__setattr__(self, "children", tuple(children))

    def __repr__(self):
        return "Or(" + ", ".join(repr(c) for c in self.children) + ")"


@dataclasses.dataclass(frozen=True)
class Not:
    child: "BoolExpr"


BoolExpr = Union[Predicate, And, Or, Not]

# a literal is what DNF conjuncts are made of: a leaf or a negated leaf
Literal = Union[Predicate, Not]


def is_leaf(expr) -> bool:
    return isinstance(expr, (Range, GeoWithin, TextContains, VectorRange))


def is_literal(expr) -> bool:
    return is_leaf(expr) or (isinstance(expr, Not) and is_leaf(expr.child))


def leaf_predicates(expr) -> List[Predicate]:
    """Every leaf predicate in the expression, negation stripped."""
    if expr is None:
        return []
    if is_leaf(expr):
        return [expr]
    if isinstance(expr, Not):
        return leaf_predicates(expr.child)
    if isinstance(expr, (And, Or)):
        out: List[Predicate] = []
        for c in expr.children:
            out.extend(leaf_predicates(c))
        return out
    raise TypeError(f"unknown filter expression {expr!r}")


def expr_cols(expr) -> List[str]:
    """Columns referenced by the expression (deduped, stable order)."""
    return list(dict.fromkeys(p.col for p in leaf_predicates(expr)))


def conjunction_literals(expr) -> List[Literal]:
    """Flatten a pure conjunction into its literal list.

    Accepts None (-> []), a single literal, or (nested) ``And`` of
    literals.  Raises ``ValueError`` for expressions containing ``Or`` or
    non-leaf negation — callers needing those must plan via ``to_dnf``.
    """
    if expr is None:
        return []
    if is_literal(expr):
        return [expr]
    if isinstance(expr, And):
        out: List[Literal] = []
        for c in expr.children:
            out.extend(conjunction_literals(c))
        return out
    raise ValueError(f"not a pure conjunction: {expr!r}")


# ---------------------------------------------------------------------------
# DNF normalization
# ---------------------------------------------------------------------------

def _nnf(expr, negate: bool):
    """Negation normal form: push Not down to the leaves (De Morgan)."""
    if is_leaf(expr):
        return Not(expr) if negate else expr
    if isinstance(expr, Not):
        return _nnf(expr.child, not negate)
    if isinstance(expr, And):
        kids = tuple(_nnf(c, negate) for c in expr.children)
        return Or(kids) if negate else And(kids)
    if isinstance(expr, Or):
        kids = tuple(_nnf(c, negate) for c in expr.children)
        return And(kids) if negate else Or(kids)
    raise TypeError(f"unknown filter expression {expr!r}")


def _distribute(expr) -> List[Tuple[Literal, ...]]:
    """NNF expression -> list of conjuncts (AND distributed over OR)."""
    if is_literal(expr):
        return [(expr,)]
    if isinstance(expr, Or):
        out: List[Tuple[Literal, ...]] = []
        for c in expr.children:
            out.extend(_distribute(c))
        return out
    if isinstance(expr, And):
        acc: List[Tuple[Literal, ...]] = [()]
        for c in expr.children:
            acc = [a + b for a in acc for b in _distribute(c)]
        return acc
    raise TypeError(f"unknown filter expression {expr!r}")


def _complement(lit: Literal) -> Literal:
    return lit.child if isinstance(lit, Not) else Not(lit)


def to_dnf(expr) -> List[Tuple[Literal, ...]]:
    """Normalize a filter expression to disjunctive normal form.

    Returns a list of conjuncts; each conjunct is a tuple of literals
    (leaf predicates, possibly ``Not``-wrapped).  The degenerate values
    follow the boolean algebra: ``None`` (no filter — always true)
    returns ``[()]``, the single empty conjunct; an unsatisfiable
    expression returns ``[]``, the empty disjunction (always false) —
    the two MUST stay distinct or a contradictory WHERE would match
    every row.  The result is simplified: duplicate literals within a
    conjunct are dropped, contradictory conjuncts (p AND NOT p) removed,
    duplicate conjuncts deduped, and absorbed conjuncts (supersets of
    another conjunct) pruned — making normalization idempotent.
    """
    if expr is None:
        return [()]
    conjuncts = []
    for raw in _distribute(_nnf(expr, negate=False)):
        lits = tuple(dict.fromkeys(raw))          # dedup, stable order
        if any(_complement(lt) in lits for lt in lits):
            continue                              # p AND NOT p: always false
        conjuncts.append(lits)
    # dedup + absorption: a conjunct strictly containing another conjunct's
    # literal set matches a subset of its rows and can be dropped
    sets = [frozenset(c) for c in conjuncts]
    keep: List[Tuple[Literal, ...]] = []
    seen = set()
    for i, c in enumerate(conjuncts):
        if sets[i] in seen:
            continue
        if any(sets[j] < sets[i] for j in range(len(conjuncts)) if j != i):
            continue
        seen.add(sets[i])
        keep.append(c)
    return keep


def from_dnf(conjuncts: Sequence[Sequence[Literal]]):
    """Inverse of ``to_dnf``: rebuild an expression from conjunct lists.
    ``[()]`` (always true) maps back to None; ``[]`` (always false) has
    no expression form and raises."""
    if not conjuncts:
        raise ValueError("empty DNF (always false) has no expression form")
    terms = []
    for c in conjuncts:
        c = tuple(c)
        if not c:
            return None                # TRUE conjunct absorbs everything
        terms.append(c[0] if len(c) == 1 else And(c))
    return terms[0] if len(terms) == 1 else Or(tuple(terms))


# ---------------------------------------------------------------------------
# rank terms
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True, eq=False)
class VectorRank:
    col: str
    q: np.ndarray
    weight: float = 1.0

    def __post_init__(self):
        object.__setattr__(self, "q", np.asarray(self.q, np.float32))
        object.__setattr__(self, "weight", float(self.weight))

    def __eq__(self, other):
        return (isinstance(other, VectorRank) and self.col == other.col
                and self.weight == other.weight
                and self.q.shape == other.q.shape
                and self.q.tobytes() == other.q.tobytes())

    def __hash__(self):
        return hash((self.col, self.q.tobytes(), self.weight))

    def __repr__(self):
        return f"VectorRank({self.col}, dim={self.q.shape}, w={self.weight})"


@dataclasses.dataclass(frozen=True)
class SpatialRank:
    col: str
    point: Tuple[float, float]
    weight: float = 1.0


@dataclasses.dataclass(frozen=True)
class TextRank:
    col: str
    terms: Tuple[str, ...]
    weight: float = 1.0


RankTerm = Union[VectorRank, SpatialRank, TextRank]


# ---------------------------------------------------------------------------
# query
# ---------------------------------------------------------------------------

class HybridQuery:
    """One declarative hybrid query: ``where`` is a boolean filter
    expression tree (or None), ``ranks`` the weighted rank terms.

    The legacy ``filters=[p1, p2]`` keyword is kept as a compat shim
    (list => implicit ``And``) and emits a ``DeprecationWarning``.
    """

    def __init__(self, where: Optional[BoolExpr] = None,
                 ranks: Sequence[RankTerm] = (), k: int = 10,
                 select: Optional[Sequence[str]] = None,
                 filters: Optional[Sequence[Predicate]] = None,
                 recall_target: Optional[float] = None):
        if isinstance(where, (list, tuple)):       # implicit conjunction
            where = None if not where else \
                where[0] if len(where) == 1 else And(tuple(where))
        if filters is not None:
            warnings.warn(
                "HybridQuery(filters=[...]) is deprecated; pass "
                "where=And(...) (or a single predicate) instead",
                DeprecationWarning, stacklevel=2)
            if where is not None:
                raise ValueError("pass either where= or filters=, not both")
            filters = list(filters)
            where = None if not filters else \
                filters[0] if len(filters) == 1 else And(tuple(filters))
        self.where = where
        self.ranks: List[RankTerm] = list(ranks)
        self.k = int(k)
        self.select = select
        # NN recall/latency knob: None (default) demands exact results;
        # a target < 1.0 lets the planner choose the quantized dispatch
        # (PQ-ADC candidate generation + exact re-rank of refine*k rows)
        if recall_target is not None:
            recall_target = float(recall_target)
            if not 0.0 < recall_target <= 1.0:
                raise ValueError(
                    f"recall_target must be in (0, 1], got {recall_target}")
        self.recall_target = recall_target

    @property
    def is_nn(self) -> bool:
        return bool(self.ranks)

    @property
    def filters(self) -> List[Literal]:
        """Flat literal list when ``where`` is a pure conjunction (the
        shape every pre-expression-tree caller assumed).  Raises
        ``ValueError`` for disjunctive expressions — those execute through
        DNF plans, never a flat AND loop."""
        return conjunction_literals(self.where)

    def __repr__(self):
        return (f"HybridQuery(where={self.where!r}, ranks={self.ranks!r}, "
                f"k={self.k})")


# ---------------------------------------------------------------------------
# continuous query declarations (Type 3 / Type 4)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class SyncQuery:
    """Re-execute every ``interval_s`` seconds (SYNC 60 seconds)."""
    query: HybridQuery
    interval_s: float
    name: str = ""


@dataclasses.dataclass
class AsyncQuery:
    """Re-execute when underlying data changes (ASYNC)."""
    query: HybridQuery
    name: str = ""
