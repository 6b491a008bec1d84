"""Batched limb, curve, fixed-base and BSGS ops on torch tensors."""
