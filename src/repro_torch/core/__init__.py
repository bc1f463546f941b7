"""Precision policy, formats and runtime knobs of the port."""
