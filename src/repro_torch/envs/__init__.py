"""Executable agent environments (FinanceBench-like only in this port)."""
