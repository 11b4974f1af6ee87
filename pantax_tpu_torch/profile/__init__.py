"""Strain profiling: PAO solver, two-stage engine, report writers."""
