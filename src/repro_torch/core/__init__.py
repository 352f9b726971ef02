"""The ARCADE store, its indexes, planner, operators and executor."""
