"""Incremental materialized views for continuous queries (paper §6):
view types (``view``), selection under a memory budget (``selection``),
maintenance from write deltas (``maintenance``) and query rewriting
(``rewrite``)."""
