"""Checkers of the port: the CPU linearizability oracle (:mod:`.linear`)."""
