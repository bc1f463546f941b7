"""Command-line drivers."""
