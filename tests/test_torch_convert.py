"""State of the JAX package carried into the port through
rofl_tpu_torch.convert (numpy only) gives the same results as the port's
own state. Tolerance: exact equality. (A JAX fixed-base table through
convert: test_torch_fixed_base.py, which builds those tables anyway.)"""

import numpy as np
import jax.numpy as jnp
import torch

from rofl_tpu.crypto import pedersen as jpedersen
from rofl_tpu.ops import bsgs as jbsgs
from rofl_tpu.ops import curve as jcurve
from rofl_tpu_torch import convert
from rofl_tpu_torch.crypto import pedersen as tpedersen
from rofl_tpu_torch.ops import bsgs as tbsgs
from rofl_tpu_torch.ops import curve as tcurve
from rofl_tpu_torch.ops import fe as tfe
from rofl_tpu_torch.ops import sc as tsc
from rofl_tpu_torch.spec import ristretto as SR
from torch_port_helpers import share_tables_with_jax

torch.set_num_threads(1)  # tiny ops; the suite runs several workers side by side
rng = np.random.default_rng(606)
N = 77
M = 64


def as_numpy(j_point):
    return [np.asarray(c) for c in j_point]


def test_limbs_roundtrip():
    limbs = rng.integers(0, 1 << 16, size=(16, N)).astype(np.uint32)
    t = convert.limbs_to_tensor(limbs, "cpu")
    assert t.dtype == torch.int32 and t.shape == (16, N)
    back = convert.tensor_to_limbs(t)
    assert back.dtype == np.uint32
    np.testing.assert_array_equal(back, limbs)
    np.testing.assert_array_equal(back, np.asarray(jnp.asarray(limbs)))


def test_jax_points_give_the_ports_results():
    pts = [SR.hash_from_bytes_sha512(rng.bytes(16)) for _ in range(N)]
    j_a = jcurve.pack_points(pts)
    j_b = jcurve.double(j_a)  # a JAX result, Z != 1
    t_a = convert.point_from_numpy(*as_numpy(j_a), device="cpu")
    t_b = convert.point_from_numpy(*as_numpy(j_b), device="cpu")
    for t_c, own in zip(t_a, tcurve.pack_points(pts, "cpu")):
        assert torch.equal(t_c, own)
    got = convert.point_to_numpy(tcurve.add(t_a, t_b))
    for g, w in zip(got, as_numpy(jcurve.add(j_a, j_b))):
        assert g.dtype == np.uint32
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(tcurve.compress_to_bytes(t_b), jcurve.compress_to_bytes(j_b))


def test_jax_bsgs_table_gives_the_ports_results():
    share_tables_with_jax("base_B")  # the JAX table build multiplies by base B
    j_keys, j_vals, _ = jbsgs.build_table(M)
    keys, vals = convert.bsgs_table_from_numpy(j_keys, j_vals, device="cpu")
    own_keys, own_vals = tbsgs.build_table(M, "cpu")
    assert keys.dtype == own_keys.dtype and vals.dtype == own_vals.dtype
    assert torch.equal(keys, own_keys)
    assert torch.equal(vals, own_vals)
    logs = [0, 1, -1, 64, -64, 100, 128, -128, 129, 500]
    pts = tpedersen.pedersen_commit_no_blinding(tfe.to_tensor(tsc.pack_scalars(logs), "cpu"))
    neg_mG = tbsgs.neg_mG_coords(M, "cpu")
    val_a, ok_a = tbsgs.solve_with_table(keys, vals, neg_mG, pts, M, 2)
    val_b, ok_b = tbsgs.solve_discrete_log(pts, M, 7)
    assert torch.equal(val_a, val_b) and torch.equal(ok_a, ok_b)
    assert ok_a.tolist() == [abs(v) <= 128 for v in logs]
