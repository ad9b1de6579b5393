"""Utilities: profiling annotations, the native host library."""

from .profiling import annotate, trace  # noqa: F401
