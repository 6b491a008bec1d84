"""The server's accumulator of the port (``fl/params.py`` ``Accumulator``,
``convert.accumulator_*``) against the JAX package, on the CPU (plain
versions).

Three EncRangeCompressed clients with cancelling blindings, made by the JAX
package (tests/data/torch_port_modes_kat.json), accumulated by the port:
``extract`` with a table of 2^12 (the JAX package's, in the KAT, used the
server's 2^16; the values do not depend on the table) equals the JAX
package's extract and numpy's
fixed-point sum of the clients' values plus the one unit that the
accumulator's start from (B, B) pairs adds (both packages extract that);
two of the three clients do not cancel and extract None; an update of
another size or kind is refused; Plain mode sums on the host as the JAX
package does; the JAX accumulator's state carries across. Tolerance: none
(float32 values equal)."""

import numpy as np
import pytest
import torch

from rofl_tpu.crypto.fp_codec import FpConfig as JFpConfig
from rofl_tpu.fl import params as JP
from rofl_tpu_torch import convert
from rofl_tpu_torch.crypto.fp_codec import FpConfig
from rofl_tpu_torch.fl import params as P
from rofl_tpu_torch.ops import curve
from test_torch_modes_kat import load_kat
from test_torch_modes_params import without_autograd  # noqa: F401 (autouse)

torch.set_num_threads(2)
KAT = load_kat()
ACC = KAT["accumulator"]
FP = FpConfig(*KAT["fp"])
JFP = JFpConfig(*KAT["fp"])
D = len(KAT["values"])
ENC = ACC["enc_type"]
BSGS_M = 1 << 12  # 16 giant steps on the CPU; a table of 2^16 takes minutes to build there


def clients():
    return [P.deserialize(ENC, bytes.fromhex(c), FP, "cpu") for c in ACC["clients"]]


@pytest.fixture(scope="module")
def filled():
    acc = P.Accumulator(ENC, D, FP, bsgs_m=BSGS_M, device="cpu")
    assert all(acc.accumulate(c) for c in clients())
    return acc


def test_extract_equals_the_kat_and_the_fixed_point_sum(filled):
    got = filled.extract()
    assert got.dtype == np.float32 and got.tolist() == ACC["extracted"]
    units = np.rint(np.asarray(ACC["values"], np.float64) * FP.scale).astype(np.int64)
    np.testing.assert_array_equal(got, ((units.sum(axis=0) + 1) / FP.scale).astype(np.float32))


def test_blindings_that_do_not_cancel_extract_none():
    acc = P.Accumulator(ENC, D, FP, bsgs_m=BSGS_M, device="cpu")
    for c in clients()[:2]:
        assert acc.accumulate(c)
    assert acc.extract() is None


def test_updates_of_another_size_or_kind_are_refused():
    enc = clients()[0]
    other_size = P.Accumulator(ENC, D + 1, FP, device="cpu")
    assert not other_size.accumulate(enc)
    assert not P.Accumulator(ENC, D, FP, device="cpu").accumulate(P.PlainParams(np.zeros(D)))
    plain = P.Accumulator(P.PLAIN_TYPE, D, FP, device="cpu")
    assert not plain.accumulate(enc)
    assert not plain.accumulate(P.PlainParams(np.zeros(D + 1, np.float32)))


def test_plain_mode_sums_as_the_jax_package():
    rows = np.asarray(ACC["values"], np.float32)
    ours = P.Accumulator(P.PLAIN_TYPE, D, FP, device="cpu")
    theirs = JP.Accumulator(JP.PLAIN_TYPE, D, JFP)
    for row in rows:
        assert ours.accumulate(P.PlainParams(row)) and theirs.accumulate(JP.PlainParams(row))
    np.testing.assert_array_equal(ours.extract(), theirs.extract())


def test_the_default_table_is_the_jax_packages():
    assert P.Accumulator(P.PLAIN_TYPE, 1, FP).bsgs_m == JP.Accumulator(JP.PLAIN_TYPE, 1,
                                                                       JFP).bsgs_m == 1 << 16


def test_the_jax_accumulators_state_carries_across(filled):
    """The JAX accumulator's start, (B, B) pairs, becomes the port's; the
    port's filled state goes through numpy and back and extracts the same."""
    start = JP.Accumulator(ENC, D, JFP, bsgs_m=BSGS_M)
    state = tuple(tuple(np.asarray(c) for c in p) for p in start.pairs)
    acc = convert.accumulator_from_numpy(ENC, D, JFP, BSGS_M, state, device="cpu")
    ours = P.Accumulator(ENC, D, FP, device="cpu")
    assert curve.eq(acc.pairs.L, ours.pairs.L).all() and curve.eq(acc.pairs.R,
                                                                   ours.pairs.R).all()
    fields = convert.accumulator_to_numpy(filled)
    again = convert.accumulator_from_numpy(*fields, device="cpu")
    assert again.extract().tolist() == ACC["extracted"]
    plain = convert.accumulator_from_numpy(P.PLAIN_TYPE, D, JFP, 4096,
                                           np.arange(D, dtype=np.float32), device="cpu")
    np.testing.assert_array_equal(plain.extract(), np.arange(D, dtype=np.float32))
