"""Continuous-batching engine and scheduler."""
