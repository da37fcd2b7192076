"""The decoder model (dense family) and its building blocks."""
