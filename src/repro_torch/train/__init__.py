"""Serve-side step factories."""
