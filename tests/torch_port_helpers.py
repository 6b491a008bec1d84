"""Shared by the tests/test_torch_*.py files that hold the port against the
JAX package."""

import jax.numpy as jnp

from rofl_tpu.crypto import pedersen as jpedersen
from rofl_tpu.ops import curve as jcurve
from rofl_tpu_torch.crypto import pedersen as tpedersen
from rofl_tpu_torch.ops import fe as tfe


def share_tables_with_jax(*names):
    """Give the JAX package the port's fixed-base tables ("base_B",
    "base_H"), so that a test file does not pay the JAX table build on the CPU
    again. A file that calls this compares everything above the tables, not
    the tables: test_torch_fixed_base.py builds both packages' tables
    independently and holds them equal, and test_torch_slice.py runs the
    whole round on each package's own tables."""
    for name in names:
        table = getattr(tpedersen, name)().table("cpu")
        getattr(jpedersen, name)()._table = jcurve.PointArray(
            *[jnp.asarray(tfe.to_numpy(c)) for c in table])
