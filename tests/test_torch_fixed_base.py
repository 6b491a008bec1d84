"""rofl_tpu_torch.ops.fixed_base against rofl_tpu.ops.fixed_base (JAX CPU
gather path) and the spec. Tolerance: exact equality of limbs and bytes."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from rofl_tpu.crypto import pedersen as jpedersen
from rofl_tpu.ops import fixed_base as jfb
from rofl_tpu_torch import convert
from rofl_tpu_torch.crypto import pedersen as tpedersen
from rofl_tpu_torch.ops import curve as tcurve
from rofl_tpu_torch.ops import fe as tfe
from rofl_tpu_torch.ops import fixed_base as tfb
from rofl_tpu_torch.ops import sc as tsc
from rofl_tpu_torch.spec import generators as G
from rofl_tpu_torch.spec import scalar as SS

torch.set_num_threads(1)  # tiny ops; the suite runs several workers side by side
rng = np.random.default_rng(505)
N = 77
SCALARS = [0, 1, 2, 255, 256, 65535, 65536, SS.L - 1, SS.L - 2] + [
    int.from_bytes(rng.bytes(32), "little") % SS.L for _ in range(N - 9)]
K_NP = tsc.pack_scalars(SCALARS)

BASES = {
    "B": (tpedersen.base_B, jpedersen.base_B, G.pedersen_B),
    "H": (tpedersen.base_H, jpedersen.base_H, G.pedersen_B_blinding),
}


def same_point(t_pt, j_pt):
    for t_c, j_c in zip(t_pt, j_pt):
        t_np, j_np = t_c.numpy(), np.asarray(j_c)
        assert t_np.shape == j_np.shape
        np.testing.assert_array_equal(t_np.astype(np.int64), j_np.astype(np.int64))


@pytest.mark.parametrize("base", sorted(BASES))
def test_table_equals_the_jax_table(base):
    t_base, j_base, _ = BASES[base]
    t_tab = t_base().table("cpu")
    assert t_tab.x.shape == (16, tfb.N_WINDOWS, 256) and t_tab.x.dtype == tfe.DTYPE
    same_point(t_tab, j_base().table)


@pytest.mark.parametrize("base", sorted(BASES))
def test_table_entries_compress_to_the_spec(base):
    t_base, _, spec_base = BASES[base]
    tab = t_base().table("cpu")
    picks = [(0, 0), (0, 1), (0, 255), (1, 1), (7, 200), (31, 1), (31, 255)]
    entries = tcurve.PointArray(*[
        torch.stack([c[:, w, d] for w, d in picks], dim=1) for c in tab])
    got = [bytes(r) for r in tcurve.compress_to_bytes(entries)]
    assert got == [spec_base().scalar_mul(d << (8 * w)).compress() for w, d in picks]


def test_jax_table_through_convert_gives_the_ports_results():
    """A table built by the JAX package, carried over as numpy."""
    j_table = [np.asarray(c) for c in jpedersen.base_H().table]
    table = convert.fixed_base_table_from_numpy(*j_table, device="cpu")
    own = tpedersen.base_H().table("cpu")
    k = tfe.to_tensor(K_NP[:, :12], "cpu")
    for a, b in zip(tfb.mul(table, k), tfb.mul(own, k)):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        convert.fixed_base_table_from_numpy(*[c[:, :1] for c in j_table], device="cpu")


def test_table_is_cached_per_device():
    fb = tpedersen.base_B()
    assert fb.table("cpu") is fb.table(torch.device("cpu"))


@pytest.mark.parametrize("base", sorted(BASES))
def test_mul(base):
    t_base, j_base, spec_base = BASES[base]
    got = t_base().mul(tfe.to_tensor(K_NP, "cpu"))
    same_point(got, j_base().mul(jnp.asarray(K_NP)))
    assert [bytes(r) for r in tcurve.compress_to_bytes(got)] == [
        spec_base().scalar_mul(k).compress() for k in SCALARS]


def test_mul_of_one_lane():
    k = tfe.to_tensor(K_NP[:, 9:10], "cpu")
    got = tfb.mul(tpedersen.base_B().table("cpu"), k)
    assert got.x.shape == (16, 1)
    assert bytes(tcurve.compress_to_bytes(got)[0]) == G.pedersen_B().scalar_mul(
        SCALARS[9]).compress()


def test_digits():
    got = tfb._digits(tfe.to_tensor(K_NP, "cpu"))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jfb._digits(jnp.asarray(K_NP))))
    assert [sum(int(got[w, i]) << (8 * w) for w in range(32)) for i in range(N)] == SCALARS
