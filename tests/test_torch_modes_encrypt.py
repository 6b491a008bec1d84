"""The port's encrypt in the encrypted modes (``fl/params.py``
EncParamsRange, EncParamsRangeCompressed, EncParamsL2Compressed through the
dispatch) against the JAX package, on the CPU (plain versions).

With the KAT's seeds (tests/data/torch_port_modes_kat.json, made by the JAX
package: d = 7, 2 partitions, value range 8, L2 range 16) ``encrypt`` gives
the KAT's ``serialize()`` bytes in each mode, at check_percentage 1.0 and, for
the Range modes, 0.5, which also holds the hand-written protobuf envelopes to
the protobuf runtime's. Tolerance: none (bytes equal)."""

import pytest

from test_torch_modes_kat import load_kat
from test_torch_modes_params import encrypt, without_autograd  # noqa: F401 (autouse)

KAT = load_kat()


@pytest.mark.parametrize("name", sorted(KAT["modes"]))
def test_encrypt_gives_the_kat_bytes(name):
    case = KAT["modes"][name]
    assert encrypt(KAT["values"], case).hex() == case["serialized"]
