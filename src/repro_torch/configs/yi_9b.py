"""Assigned architecture config (see registry.py for the
full definition and source citation)."""

from .registry import YI_9B

CONFIG = YI_9B
