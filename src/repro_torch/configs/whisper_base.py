"""Assigned architecture config (see registry.py for the
full definition and source citation)."""

from .registry import WHISPER_BASE

CONFIG = WHISPER_BASE
