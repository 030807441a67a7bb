"""Assigned architecture config (see registry.py for the
full definition and source citation)."""

from .registry import PHI35_MOE

CONFIG = PHI35_MOE
