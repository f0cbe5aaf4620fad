"""Workload checkers of the port (the test harness's generators are not
ported)."""
