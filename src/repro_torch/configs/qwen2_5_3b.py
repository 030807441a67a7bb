"""Assigned architecture config (see registry.py for the
full definition and source citation)."""

from .registry import QWEN25_3B

CONFIG = QWEN25_3B
