"""Runtime structural validation of planner output (``validate_plan``).

The static side of the plan family (``repro_torch.analysis.rules.plans``)
checks the planner's *source*; this module checks the planner's
*output*: every plan the optimizer emits must satisfy the operator
contracts the executor silently assumes.  Violations raise
``PlanContractError`` — a validated plan either executes correctly or
never executes at all.

Contracts checked:

- the plan kind is one the executor dispatches on;
- NN-shaped plans carry ranks and a positive ``k``; search-shaped plans
  never carry a fused/quantized dispatch;
- union kinds carry search-shaped subplans (and only union kinds do);
- no predicate appears in both ``indexed`` and ``residual`` (it would
  be applied twice, double-charging selectivity);
- fused dispatch: scan-shaped kind, a single positive-weight
  vector/spatial rank, ``0 < k <= KMAX`` (the kernel's top-k register
  budget);
- quantized dispatch: additionally a vector rank, ``pq_m > 0`` and a
  refine ladder whose ``refine * k`` survivor set still fits ``KMAX``;
- graph dispatch: additionally a vector rank, positive out-degree and
  hop count, ``k <= beam <= KMAX`` (the beam survivors are the re-rank
  candidate set), and never combined with the quantized dispatch;
- the operator tree finishes candidates in visibility order: top-k
  truncation happens ABOVE the memtable overlay, which sits ABOVE
  visibility resolution (TopKMerge -> MemtableOverlay ->
  VisibilityResolve on the root path) — pruning before visibility can
  drop a winner that a shadowed candidate displaced.

Wiring: the planner calls ``maybe_validate`` on every plan it returns
when ``REPRO_VALIDATE_PLANS=1`` (CI bench smokes set it); tests assert
``validate_plan`` directly over every TRACY template.
"""
from __future__ import annotations

import os
from typing import List

KNOWN_KINDS = {
    "full_scan", "index_intersect", "prefilter_nn", "postfilter_nn",
    "nra", "full_scan_nn", "union", "union_nn", "empty",
}
NN_KINDS = {"prefilter_nn", "postfilter_nn", "nra", "full_scan_nn",
            "union_nn"}
SEARCH_KINDS = {"full_scan", "index_intersect", "union"}
UNION_KINDS = {"union", "union_nn"}
# kinds the fused / quantized packed-scan dispatch may attach to
SCAN_NN_KINDS = {"full_scan_nn", "prefilter_nn", "union_nn"}


class PlanContractError(AssertionError):
    """A plan violates an executor contract (see module docstring)."""

    def __init__(self, plan, problems: List[str]):
        self.plan = plan
        self.problems = problems
        bullet = "\n  - ".join(problems)
        super().__init__(
            f"plan kind={getattr(plan, 'kind', '?')!r} violates "
            f"{len(problems)} contract(s):\n  - {bullet}")


def _pred_key(p) -> tuple:
    col = getattr(p, "col", None)
    return (type(p).__name__, col, id(p) if col is None else 0)


def _check_dispatch(plan, problems: List[str]) -> None:
    from repro_torch.core import query as q
    from repro_torch.kernels import fused_scan as fs_kernel
    kmax = int(fs_kernel.KMAX)
    if plan.kind not in SCAN_NN_KINDS:
        problems.append(
            f"fused/quantized dispatch on kind {plan.kind!r} — only "
            f"scan-shaped NN kinds {sorted(SCAN_NN_KINDS)} pack segments")
    if len(plan.ranks) != 1:
        problems.append(
            f"fused dispatch needs exactly one rank, got "
            f"{len(plan.ranks)} (the kernel ranks a single monotone "
            f"distance)")
    else:
        r = plan.ranks[0]
        if not isinstance(r, (q.VectorRank, q.SpatialRank)):
            problems.append(
                f"fused dispatch over a {type(r).__name__} rank — only "
                f"vector/spatial distances stream through the kernel")
        elif not getattr(r, "weight", 1.0) > 0:
            problems.append("fused dispatch with a non-positive rank "
                            "weight (distance would rank inverted)")
        if plan.quantized and not isinstance(r, q.VectorRank):
            problems.append("quantized dispatch requires a vector rank "
                            "(ADC tables are per-subspace codebooks)")
        if getattr(plan, "graph", False) and \
                not isinstance(r, q.VectorRank):
            problems.append("graph dispatch requires a vector rank "
                            "(the CSR graph is a vector proximity graph)")
    if not 0 < plan.k <= kmax:
        problems.append(
            f"fused dispatch with k={plan.k} outside (0, KMAX={kmax}] — "
            f"the kernel's top-k registers can't hold the result")
    if plan.quantized:
        if plan.pq_m <= 0:
            problems.append(f"quantized dispatch with pq_m={plan.pq_m}")
        if plan.refine < 2:
            problems.append(
                f"quantized dispatch with refine={plan.refine} < 2 — "
                f"the exact re-rank needs headroom over k")
        elif plan.refine * plan.k > kmax:
            problems.append(
                f"quantized survivor set refine*k={plan.refine * plan.k} "
                f"exceeds KMAX={kmax}")
    if getattr(plan, "graph", False):
        if plan.quantized:
            problems.append(
                "graph and quantized dispatch on one plan — the executor "
                "groups by a single candidate-generation strategy")
        if plan.graph_r <= 0:
            problems.append(f"graph dispatch with R={plan.graph_r}")
        if plan.graph_hops <= 0:
            problems.append(
                f"graph dispatch with hops={plan.graph_hops} — the "
                f"traversal would never leave the entry points")
        if not plan.k <= plan.graph_beam <= kmax:
            problems.append(
                f"graph beam={plan.graph_beam} outside [k={plan.k}, "
                f"KMAX={kmax}] — the beam survivors are the re-rank "
                f"candidate set")


def _check_tree(plan, problems: List[str]) -> None:
    from repro_torch.core import operators as ops_lib
    try:
        root = plan.operator_tree()
    except Exception as e:  # tree construction itself is part of the check
        problems.append(f"operator tree construction failed: {e!r}")
        return
    if plan.kind == "empty":
        if not isinstance(root, ops_lib.EmptyResult):
            problems.append(
                f"kind 'empty' must render an EmptyResult root, got "
                f"{type(root).__name__}")
        return
    # walk the root finisher chain: TopKMerge (NN only) above
    # MemtableOverlay above VisibilityResolve
    node = root
    if plan.kind in NN_KINDS:
        if not isinstance(node, ops_lib.TopKMerge):
            problems.append(
                f"NN plan root must be TopKMerge (truncation happens "
                f"last), got {type(node).__name__}")
            return
        node = node.children[0] if node.children else None
    if not isinstance(node, ops_lib.MemtableOverlay):
        problems.append(
            f"expected MemtableOverlay below the root (unflushed rows "
            f"must join before truncation), got "
            f"{type(node).__name__ if node else None}")
        return
    node = node.children[0] if node.children else None
    if not isinstance(node, ops_lib.VisibilityResolve):
        problems.append(
            f"expected VisibilityResolve below MemtableOverlay (top-k "
            f"over unresolved versions can keep a shadowed row), got "
            f"{type(node).__name__ if node else None}")


def validate_plan(plan) -> None:
    """Raise ``PlanContractError`` if ``plan`` violates any executor
    contract; a clean pass returns None."""
    problems: List[str] = []
    kind = getattr(plan, "kind", None)
    if kind not in KNOWN_KINDS:
        raise PlanContractError(plan, [
            f"unknown plan kind {kind!r} — executor dispatch would fall "
            f"through to the generic shape"])

    if kind in NN_KINDS:
        if not plan.ranks and kind != "union_nn":
            problems.append(f"NN kind {kind!r} with no ranks")
        if plan.k <= 0:
            problems.append(f"NN kind {kind!r} with k={plan.k}")
    if kind in SEARCH_KINDS and (plan.fused or plan.quantized or
                                 getattr(plan, "graph", False)):
        problems.append(
            f"search kind {kind!r} carries a scan dispatch — "
            f"there is no scan->top-k to fuse")

    if kind in UNION_KINDS:
        if not plan.subplans:
            problems.append(f"{kind!r} with no subplans (DNF must have "
                            f"at least one conjunct)")
        for i, sp in enumerate(plan.subplans):
            if sp.kind not in ("full_scan", "index_intersect"):
                problems.append(
                    f"subplan[{i}] has kind {sp.kind!r} — union children "
                    f"must be search-shaped (the OR-merge unions bitmaps)")
            overlap = [c for c in sp.indexed if c in sp.residual]
            if overlap:
                problems.append(
                    f"subplan[{i}] applies predicate(s) twice "
                    f"(indexed AND residual): {overlap}")
    elif plan.subplans:
        problems.append(f"kind {kind!r} carries {len(plan.subplans)} "
                        f"subplans — only union kinds fan out over DNF")

    overlap = [p for p in plan.indexed if p in plan.residual]
    if overlap:
        problems.append(
            f"predicate(s) in both indexed and residual: {overlap} — "
            f"selectivity is charged twice and NOT probes are unsound")

    if plan.fused or plan.quantized or getattr(plan, "graph", False):
        _check_dispatch(plan, problems)

    _check_tree(plan, problems)

    if problems:
        raise PlanContractError(plan, problems)


def validation_enabled() -> bool:
    return os.environ.get("REPRO_VALIDATE_PLANS", "") not in ("", "0")


def maybe_validate(plan):
    """Planner hook: validate when REPRO_VALIDATE_PLANS=1, pass through
    otherwise.  Returns the plan so call sites stay expressions."""
    if validation_enabled():
        validate_plan(plan)
    return plan
