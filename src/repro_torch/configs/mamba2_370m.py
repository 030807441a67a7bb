"""Assigned architecture config (see registry.py for the
full definition and source citation)."""

from .registry import MAMBA2_370M

CONFIG = MAMBA2_370M
