"""Assigned architecture config (see registry.py for the
full definition and source citation)."""

from .registry import PHI3_MEDIUM

CONFIG = PHI3_MEDIUM
