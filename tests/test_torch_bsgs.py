"""rofl_tpu_torch.ops.bsgs against rofl_tpu.ops.bsgs (JAX CPU path) and
against known discrete logs. Tolerance: exact equality of limbs and masks.

The JAX side compiles its whole walk per (m, max_it, lane count) for minutes
on JAX:CPU, so its walk is read from tests/data/torch_port_jax_kat.json
(made and kept honest by tests/test_torch_jax_kat.py) for one small
configuration: m = 128, n_bits = 8 (two giant steps) on 77 lanes. The longer
walk (m = 64, four steps) is held against the known values."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rofl_tpu.ops import bsgs as jbsgs
from rofl_tpu_torch.crypto import pedersen as tpedersen
from rofl_tpu_torch.ops import bsgs as tbsgs
from rofl_tpu_torch.ops import fe as tfe
from rofl_tpu_torch.ops import sc as tsc
from rofl_tpu_torch.spec import field as SF
from rofl_tpu_torch.spec import scalar as SS
from test_torch_jax_kat import load_kat

torch.set_num_threads(1)  # tiny ops; the suite runs several workers side by side
rng = np.random.default_rng(321)
N = 77
M, N_BITS = 128, 8
# In range: |v| <= 256 (two steps of 128). 300, -300 and 1000 are not found.
LOGS = [0, 1, -1, 127, 128, 129, 255, 256, -127, -128, -129, -255, -256, 300, -300,
        1000] + [int(v) for v in rng.integers(-256, 257, N - 16)]
FOUND = [abs(v) <= 256 for v in LOGS]
K_NP = tsc.pack_scalars(LOGS)


def key_limbs():
    """Canonical field limbs whose keys stress the unsigned order: words with
    the top bit set beside words without, equal prefixes, 0 and p - 1."""
    vals = [0, 1, SF.P - 1, 1 << 31, (1 << 31) - 1, (1 << 31) + 1, 1 << 32,
            (1 << 255) - 21, 0x80000000 << 224, 0x7FFFFFFF << 224, 0xFFFFFFFF << 192,
            (0x80000000 << 224) + 5, (0x80000000 << 224) + (1 << 31)]
    vals += [int.from_bytes(rng.bytes(32), "little") % SF.P for _ in range(40)]
    return vals, tfe.pack_scalars(vals)


def test_limbs_to_keys_keep_unsigned_order():
    vals, limbs = key_limbs()
    t_keys = tbsgs._limbs_to_keys(tfe.to_tensor(limbs, "cpu"))
    assert t_keys.dtype == torch.int32 and t_keys.shape == (8, len(vals))
    j_keys = np.asarray(jbsgs._limbs_to_keys(jnp.asarray(limbs)))
    # the stored word is the JAX word with its top bit flipped
    np.testing.assert_array_equal(t_keys.numpy().astype(np.int64) + (1 << 31),
                                  j_keys.astype(np.int64))
    assert (t_keys.numpy() < 0).any() and (t_keys.numpy() >= 0).any()


def test_lex_less_is_unsigned_integer_order():
    vals, limbs = key_limbs()
    keys = tbsgs._limbs_to_keys(tfe.to_tensor(limbs, "cpu"))
    n = len(vals)
    a = keys[:, torch.arange(n).repeat_interleave(n)]
    b = keys[:, torch.arange(n).repeat(n)]
    got = tbsgs._lex_less(a, b).reshape(n, n)
    want = [[x < y for y in vals] for x in vals]
    assert got.tolist() == want
    j_keys = jbsgs._limbs_to_keys(jnp.asarray(limbs))
    j_got = jbsgs._lex_less(j_keys[:, np.repeat(np.arange(n), n)],
                            j_keys[:, np.tile(np.arange(n), n)])
    np.testing.assert_array_equal(got.numpy().reshape(-1), np.asarray(j_got))


def test_sort_and_binary_search_with_top_bit_keys():
    vals, limbs = key_limbs()
    vals = vals[:-3]  # keep three values out of the table
    keys = tbsgs._limbs_to_keys(tfe.to_tensor(limbs, "cpu"))
    table_keys, table_vals = tbsgs.sort_table(
        keys[:, :len(vals)], torch.arange(len(vals), dtype=torch.int32))
    order = sorted(range(len(vals)), key=lambda i: vals[i])
    assert table_vals.tolist() == order
    idx, hit = tbsgs._binary_search(table_keys, keys)
    assert hit.tolist() == [True] * len(vals) + [False] * 3
    assert table_vals[idx][: len(vals)].tolist() == list(range(len(vals)))
    # the JAX search over the same table (unbiased words) hits the same rows
    j_table = jnp.asarray((table_keys.numpy().astype(np.int64) + (1 << 31)).astype(np.uint32))
    j_idx, j_hit = jbsgs._binary_search(j_table, jbsgs._limbs_to_keys(jnp.asarray(limbs)))
    np.testing.assert_array_equal(hit.numpy(), np.asarray(j_hit))
    np.testing.assert_array_equal(idx.numpy()[: len(vals)], np.asarray(j_idx)[: len(vals)])


def test_build_table_is_sorted_complete_and_memoised():
    keys, vals = tbsgs.build_table(M, "cpu")
    assert keys.shape == (M + 1, 8) and keys.dtype == torch.int32
    assert sorted(vals.tolist()) == list(range(M + 1))
    assert tbsgs._lex_less(keys[:-1].T, keys[1:].T).all()
    assert tbsgs.build_table(M, torch.device("cpu"))[0] is keys


def test_solve_equals_jax_solve():
    """Negatives, 0, both ends of each giant step, and values out of range,
    against the JAX walk on the same logs (the KAT's value limbs and found
    mask)."""
    kat = load_kat()["bsgs"]
    assert (kat["logs"], kat["m"], kat["n_bits"]) == (LOGS, M, N_BITS)
    t_pts = tpedersen.pedersen_commit_no_blinding(tfe.to_tensor(K_NP, "cpu"))
    t_val, t_ok = tbsgs.solve_discrete_log(t_pts, M, N_BITS)
    np.testing.assert_array_equal(t_ok.numpy(), np.asarray(kat["found"]))
    np.testing.assert_array_equal(tfe.to_numpy(t_val), np.asarray(kat["values"], np.uint32))
    assert t_ok.tolist() == FOUND
    got = tsc.unpack_scalars(t_val)
    assert [g for g, f in zip(got, FOUND) if f] == [
        v % SS.L for v, f in zip(LOGS, FOUND) if f]


@pytest.mark.parametrize("m,n_bits,max_it", [(64, 8, None), (64, 8, 2), (16, 6, None)])
def test_small_table_walks_giant_steps(m, n_bits, max_it):
    logs = [0, 1, -1, 63, 64, 65, -64, -65, 128, 191, 192, 255, 256, -256, 257, -257, 1000]
    pts = tpedersen.pedersen_commit_no_blinding(
        tfe.to_tensor(tsc.pack_scalars(logs), "cpu"))
    val, ok = tbsgs.solve_discrete_log(pts, m, n_bits, max_it)
    steps = max_it or (1 << n_bits) // m
    want_ok = [abs(v) <= steps * m for v in logs]
    assert ok.tolist() == want_ok
    got = tsc.unpack_scalars(val)
    assert [g for g, f in zip(got, want_ok) if f] == [
        v % SS.L for v, f in zip(logs, want_ok) if f]


def test_neg_mG_coords():
    from rofl_tpu_torch.ops import curve as tcurve
    from rofl_tpu_torch.spec import ristretto as SR

    t_neg = tbsgs.neg_mG_coords(M, "cpu")
    j_neg = jbsgs.neg_mG_coords(M)
    for t_c, j_c in zip(t_neg, j_neg):
        np.testing.assert_array_equal(tfe.to_numpy(t_c), np.asarray(j_c))
    assert bytes(tcurve.compress_to_bytes(t_neg)[0]) == (-SR.BASEPOINT.scalar_mul(M)).compress()
