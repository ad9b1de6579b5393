"""Inference runtime: Interpreter, benchmark, serving, evaluation."""

from .interpreter import Interpreter  # noqa: F401
