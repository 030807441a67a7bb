"""Assigned architecture config (see registry.py for the
full definition and source citation)."""

from .registry import LLAMA32_VISION

CONFIG = LLAMA32_VISION
