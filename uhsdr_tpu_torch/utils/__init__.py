"""Profiling and observability."""
