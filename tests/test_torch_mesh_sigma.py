"""The port's mesh-routed Σ-protocols against the JAX package's, on a virtual
mesh of the CPU.

``crypto/sigma.py`` runs the Σ-protocol cores a 'param' shard at a time
(``mesh=``). The JAX side is ``tests/data/torch_port_mesh_kat.json``
(tests/test_torch_mesh_kat.py: the same calls with ``mesh=param_mesh(8)`` on
8 virtual XLA:CPU devices, 50 lanes padded to 56). The proofs do not depend
on the mesh, so the port's are held to that file at 3 shards (50 lanes pad to
51). The tolerance is exact equality: encodings and scalar bytes, and the
verdicts. Each proof made with the mesh is also held against the port's
unsharded call from the same seed. On the CPU a shard's plain ladder costs
about a second and a half whatever its lanes, so every call here runs at 3
shards, the fewest that pad 50 lanes.
"""

import numpy as np
import torch

from rofl_tpu_torch.crypto import pedersen, sigma
from rofl_tpu_torch.ops import curve
from rofl_tpu_torch.parallel import mesh as pmesh
from test_torch_mesh_kat import SEEDS, SIGMA_D, load_kat, scalar_hex

torch.set_num_threads(1)  # tiny ops; the suite runs several workers side by side

CPU = torch.device("cpu")
KAT = load_kat()
MESH3 = pmesh.param_mesh(3, [CPU] * 3)  # 50 lanes pad to 51: 17 a shard


def scalars(n: int, seed: int) -> torch.Tensor:
    return pedersen.rnd_scalar_tensor(n, np.random.default_rng(seed), "cpu")


def hexes(*items) -> list:
    return [curve.compress_to_bytes(x).tobytes().hex() if isinstance(x, curve.PointArray)
            else scalar_hex(x.numpy()) for x in items]


def sigma_inputs():
    return (scalars(SIGMA_D, SEEDS["sigma_m"]), scalars(SIGMA_D, SEEDS["sigma_r"]),
            scalars(SIGMA_D, SEEDS["sigma_r2"]))


def test_rand_proofs_with_the_mesh_equal_the_jax_mesh():
    m, r, _ = sigma_inputs()
    p, c = sigma.rand_proof_prove(m, r, np.random.default_rng(SEEDS["rand_prove"]), mesh=MESH3)
    want = KAT["sigma"]["rand"]
    got = hexes(c.L, c.R, p.c_prime.L, p.c_prime.R, p.z_m, p.z_r)
    assert got == [want[k] for k in ("c_L", "c_R", "c_prime_L", "c_prime_R", "z_m", "z_r")]
    p0, c0 = sigma.rand_proof_prove(m, r, np.random.default_rng(SEEDS["rand_prove"]))
    assert hexes(c0.L, c0.R, p0.c_prime.L, p0.c_prime.R, p0.z_m, p0.z_r) == got
    ok = sigma.rand_proof_verify(p, c, mesh=MESH3)
    assert ok.shape == (SIGMA_D,) and [bool(x) for x in ok] == want["ok"] == [True] * SIGMA_D


def test_square_rand_proofs_with_the_mesh_equal_the_jax_mesh():
    m, r, r2 = sigma_inputs()
    rng = np.random.default_rng(SEEDS["square_rand_prove"])
    p, c = sigma.square_rand_proof_prove(m, r, r2, rng, mesh=MESH3)
    want = KAT["sigma"]["square_rand"]
    keys = ("c_L", "c_R", "c_sq", "c_prime_L", "c_prime_R", "c_sq_prime", "z_m", "z_r1", "z_r2")
    got = hexes(c.c.L, c.c.R, c.c_sq, p.c_prime.L, p.c_prime.R, p.c_sq_prime, p.z_m, p.z_r1,
                p.z_r2)
    assert got == [want[k] for k in keys]
    p0, c0 = sigma.square_rand_proof_prove(m, r, r2, np.random.default_rng(
        SEEDS["square_rand_prove"]))
    assert hexes(c0.c.L, c0.c.R, c0.c_sq, p0.c_prime.L, p0.c_prime.R, p0.c_sq_prime, p0.z_m,
                 p0.z_r1, p0.z_r2) == got
    ok = sigma.square_rand_proof_verify(p, c, mesh=MESH3)
    assert [bool(x) for x in ok] == want["ok"] == [True] * SIGMA_D
