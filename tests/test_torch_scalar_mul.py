"""rofl_tpu_torch.ops.curve.scalar_mul (on the CPU: the plain version of the
scalar_mul kernel) against the spec, rofl_tpu.ops.curve (JAX CPU path) and
the JAX package's Pallas kernel (interpret mode, from the KAT file).
Results are compared as canonical encodings: the raw (X:Y:Z:T) may differ
between two ladders. Tolerance: exact equality of the 32-byte encodings."""

import numpy as np
import jax.numpy as jnp
import torch

from rofl_tpu.ops import curve as jcurve
from rofl_tpu_torch.ops import curve as tcurve
from rofl_tpu_torch.ops import fe as tfe
from rofl_tpu_torch.ops import kernels as tkernels
from rofl_tpu_torch.ops import sc as tsc
from rofl_tpu_torch.spec import ristretto as SR
from rofl_tpu_torch.spec import scalar as SS
from test_torch_jax_kat import ladder_kat

torch.set_num_threads(1)  # tiny ops; the suite runs several workers side by side
rng = np.random.default_rng(255)
L = SS.L
RANDOM = [SR.hash_from_bytes_sha512(rng.bytes(16)) for _ in range(3)]
K_RANDOM = [int.from_bytes(rng.bytes(32), "little") % L for _ in range(3)]
# k = 0, 1, l-1 on a random point; the identity and the basepoint; random pairs
POINTS = [RANDOM[0]] * 3 + [SR.identity(), SR.BASEPOINT, SR.BASEPOINT] + RANDOM[1:]
SCALARS = [0, 1, L - 1, K_RANDOM[0], K_RANDOM[1], L - 1, K_RANDOM[2], 2**252]
N = len(POINTS)
K_NP = tsc.pack_scalars(SCALARS)
P_T = tcurve.pack_points(POINTS, "cpu")
K_T = tfe.to_tensor(K_NP, "cpu")


def encodings(p):
    return [bytes(r) for r in tcurve.compress_to_bytes(p)]


def jax_points(p):
    return jcurve.PointArray(*[jnp.asarray(tfe.to_numpy(c)) for c in p])


def test_scalar_mul_equals_the_spec_and_jax():
    got = tcurve.scalar_mul(P_T, K_T)
    assert got.x.shape == (16, N) and got.x.dtype == tfe.DTYPE
    want = [p.scalar_mul(k).compress() for p, k in zip(POINTS, SCALARS)]
    assert encodings(got) == want
    assert want[0] == want[3] == SR.identity().compress() and want[1] == RANDOM[0].compress()
    j_got = jcurve.scalar_mul(jax_points(P_T), jnp.asarray(K_NP))
    assert [bytes(r) for r in jcurve.compress_to_bytes(j_got)] == want
    # the same group elements under the port's own equality, lane by lane
    j_as_t = tcurve.PointArray(*[tfe.to_tensor(np.asarray(c), "cpu") for c in j_got])
    assert tcurve.eq(got, j_as_t).all()
    assert tkernels.LAUNCHES["scalar_mul"] == 0  # the CPU ran the plain version


def test_scalar_mul_with_one_scalar_for_every_point():
    k = K_RANDOM[0]
    got = tcurve.scalar_mul(P_T, K_T[:, 3:4])
    assert encodings(got) == [p.scalar_mul(k).compress() for p in POINTS]


def test_scalar_mul_walks_all_256_bits_and_keeps_batch_shape():
    """A scalar above l (not canonical) still multiplies by its full value,
    and a (16, 2, 2) batch comes back as (16, 2, 2)."""
    big = [2**256 - 1, 2**255 + 12345, L, L + 1]
    k = tfe.to_tensor(tfe.pack_scalars(big), "cpu").reshape(16, 2, 2)
    p = tcurve.PointArray(*[c[:, 4:8].reshape(16, 2, 2) for c in P_T])
    got = tcurve.scalar_mul(p, k)
    assert got.x.shape == (16, 2, 2)
    flat = tcurve.PointArray(*[c.reshape(16, 4) for c in got])
    assert encodings(flat) == [q.scalar_mul(v % L).compress() for q, v in zip(POINTS[4:8], big)]


def test_scalar_mul_equals_the_jax_pallas_kernel():
    """Against the JAX package's Pallas scalar_mul at its default one-bit
    body (interpret mode, from the KAT file tests/data/torch_port_jax_kat.json):
    k = 0, 1, 2, l-1, 2^256-1 and random ones, the identity and the
    basepoint among the points."""
    ladders, p = ladder_kat()
    k = tfe.to_tensor(tsc.pack_scalars([int(h, 16) for h in ladders["scalars"]]), "cpu")
    got = tcurve.scalar_mul(tcurve.PointArray(*p), k)
    assert [e.hex() for e in encodings(got)] == ladders["scalar_mul"]["1"]
