"""Assigned architecture config (see registry.py for the
full definition and source citation)."""

from .registry import ZAMBA2_7B

CONFIG = ZAMBA2_7B
