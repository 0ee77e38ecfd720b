"""Data sources of the port (numpy only)."""
