"""Trace, scenario and token generators for the port."""
