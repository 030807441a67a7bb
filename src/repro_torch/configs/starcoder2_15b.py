"""Assigned architecture config (see registry.py for the
full definition and source citation)."""

from .registry import STARCODER2_15B

CONFIG = STARCODER2_15B
