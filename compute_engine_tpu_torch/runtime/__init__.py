"""Inference runtime: Interpreter and benchmark."""

from .interpreter import Interpreter  # noqa: F401
