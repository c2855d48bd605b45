"""Trace generators for the port."""
