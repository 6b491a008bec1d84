"""Pure-Python executable spec (field, scalars, Ristretto255, generators)."""
