"""Collective group backends of the port."""
