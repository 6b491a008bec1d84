"""Generator derivation — bit-exact with the `bulletproofs 4.0` crate.

PedersenGens / ElGamalGens share bases (rofl_crypto/src/rand_proof/
el_gamal.rs:31-47): B = ristretto basepoint, B_blinding =
hash_from_bytes::<Sha3_512>(basepoint encoding). BulletproofGens derives
per-party G/H chains from SHAKE-256 XOFs seeded with
"GeneratorsChain" || label, reading 64 uniform bytes per point.

Only the XOF byte streams are produced here on the host; the actual
uniform-bytes→point map can be done either by the spec (small n) or by the
batched device ops (rofl_tpu_torch.ops) for large generator sets.
"""

from __future__ import annotations

import hashlib
from functools import lru_cache

from . import ristretto as R


def generators_chain_bytes(label: bytes, n_points: int, skip: int = 0) -> bytes:
    """The SHAKE-256 XOF stream for a generator chain: 64 bytes per point.

    Matches bulletproofs generators.rs GeneratorsChain (Shake256 chained over
    b"GeneratorsChain" || label; fast_forward == skip).
    """
    shake = hashlib.shake_256()
    shake.update(b"GeneratorsChain")
    shake.update(label)
    stream = shake.digest(64 * (skip + n_points))
    return stream[64 * skip:]


def party_label(prefix: bytes, party_index: int) -> bytes:
    """bulletproofs party label: [b'G'|b'H'] || u32le(party_index)."""
    return prefix + party_index.to_bytes(4, "little")


def bp_gens_uniform_bytes(n: int, party_index: int) -> tuple[bytes, bytes]:
    """(G_bytes, H_bytes): n*64 uniform bytes each for party `party_index`."""
    g = generators_chain_bytes(party_label(b"G", party_index), n)
    h = generators_chain_bytes(party_label(b"H", party_index), n)
    return g, h


@lru_cache(maxsize=None)
def pedersen_B() -> R.RistrettoPoint:
    return R.BASEPOINT


@lru_cache(maxsize=None)
def pedersen_B_blinding() -> R.RistrettoPoint:
    return R.hash_from_bytes_sha3_512(R.BASEPOINT_COMPRESSED)


@lru_cache(maxsize=None)
def bp_gens_spec(n: int, m: int) -> tuple[list, list]:
    """BulletproofGens(gens_capacity=n, party_capacity=m) as spec points.

    Returns (G, H): lists of n*m points, party-major (party j supplies
    points j*n..(j+1)*n), matching BulletproofGens::share(j) concatenation
    order used in aggregated proofs.
    """
    G: list = []
    H: list = []
    for j in range(m):
        gb, hb = bp_gens_uniform_bytes(n, j)
        for i in range(n):
            G.append(R.from_uniform_bytes(gb[64 * i: 64 * (i + 1)]))
            H.append(R.from_uniform_bytes(hb[64 * i: 64 * (i + 1)]))
    return G, H
