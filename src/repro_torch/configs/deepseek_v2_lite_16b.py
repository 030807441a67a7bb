"""Assigned architecture config (see registry.py for the
full definition and source citation)."""

from .registry import DEEPSEEK_V2_LITE

CONFIG = DEEPSEEK_V2_LITE
