"""Helpers the port's models share (port of the parts of
``repro.common`` they use)."""
