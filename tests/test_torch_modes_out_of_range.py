"""The port's encrypt with a value out of the proven range, against the JAX
package's bytes (tests/data/torch_port_modes_kat.json, ``out_of_range``), on
the CPU (plain versions). Tolerance: none (bytes equal)."""

import pytest

from test_torch_modes_kat import load_kat
from test_torch_modes_params import encrypt, without_autograd  # noqa: F401 (autouse)

KAT = load_kat()


@pytest.mark.parametrize("name", ["range", "l2_compressed"])
def test_encrypt_out_of_range_gives_the_kat_bytes(name):
    """The hazard kept from the reference: EncRange proves its rand proofs on
    the unclipped value, EncL2Compressed on the clipped one."""
    values = list(KAT["values"])
    values[KAT["out_of_range"]["lane"]] = KAT["out_of_range"]["value"]
    case = KAT["out_of_range"]["cases"][name]
    assert encrypt(values, case).hex() == case["serialized"]
