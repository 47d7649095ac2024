"""Utilities of the port (``mem``: device-memory accounting)."""
