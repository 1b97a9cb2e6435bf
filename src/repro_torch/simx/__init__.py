"""Trace generators for the port (numpy only)."""
