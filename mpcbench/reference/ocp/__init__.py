"""Optimal-control problem: spec, parameters, costs, node derivatives."""
