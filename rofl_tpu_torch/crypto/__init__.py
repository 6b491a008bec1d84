"""Commitments, fixed-point codec and wire formats."""
