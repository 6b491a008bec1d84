"""The port's mesh-routed range proofs against the JAX package's, on a
virtual mesh of the CPU.

``crypto/range_proof.py`` sends the chunk-batched prover's group sums and
MSMs (``sharded_tree_sum_groups``, ``sharded_msm_grouped``) and the
verifier's combined MSM (``sharded_msm``) through ``parallel/mesh.py`` when
it is given a mesh. The JAX side is ``tests/data/torch_port_mesh_kat.json``
(tests/test_torch_mesh_kat.py: ``create_rangeproof`` of 16 values in 8
chunks and ``verify_rangeproof`` with ``mesh=param_mesh(8)`` on 8 virtual
XLA:CPU devices). The tolerance is exact equality: proof bytes, commitment
encodings and verdicts. The proofs do not depend on the mesh. The prover
runs over 2 shards here: the 8 chunks (A, S) and the IPA's 16 fused L-R
groups divide over 2 as over 8, and each shard of a grouped MSM is a plain
ladder of about a second and a half on the CPU (8 shards take about 110 s,
2 about 60). The verifier runs over 3 shards, the fewest that pad its
combined MSM, for the proofs and for a proof with a flipped bit
(``sharded_msm`` at 8 shards is in tests/test_torch_mesh.py).
"""

import numpy as np
import torch

from rofl_tpu_torch.crypto import pedersen
from rofl_tpu_torch.crypto import range_proof as RP
from rofl_tpu_torch.crypto import range_proof_vec as rpv
from rofl_tpu_torch.crypto.fp_codec import FpConfig
from rofl_tpu_torch.ops import curve, kernels
from rofl_tpu_torch.parallel import mesh as pmesh
from test_torch_mesh_kat import (FLIP_BYTE, FLIP_PROOF, RANGE_BITS, RANGE_CHUNKS, RANGE_D,
                                 RANGE_FP, SEEDS, load_kat)

torch.set_num_threads(1)  # tiny ops; the suite runs several workers side by side

CPU = torch.device("cpu")
KAT = load_kat()["rangeproof"]


def test_range_proofs_with_the_mesh_equal_the_jax_mesh(monkeypatch):
    fp = FpConfig(*RANGE_FP)
    vals = np.random.default_rng(SEEDS["range_values"]).uniform(-0.5, 0.5, RANGE_D).astype(
        np.float32)
    assert [float(v) for v in vals] == KAT["values"]
    blind = pedersen.rnd_scalar_tensor(RANGE_D, np.random.default_rng(SEEDS["range_blind"]),
                                       "cpu")
    # the grouped MSMs run a shard at a time: one plain ladder a shard
    ladders = []
    monkeypatch.setattr(kernels, "scalar_mul_ref", lambda k, p, f=kernels.scalar_mul_ref: (
        ladders.append(k.shape[1]), f(k, p))[1])
    proofs, commits = rpv.create_rangeproof(vals, blind, fp, RANGE_BITS, RANGE_CHUNKS,
                                            np.random.default_rng(SEEDS["range_prove"]), "cpu",
                                            pmesh.param_mesh(2, [CPU] * 2))
    assert [p.to_bytes().hex() for p in proofs] == KAT["proofs"]
    assert curve.compress_to_bytes(commits).tobytes().hex() == KAT["commits"]
    # S: 2 shards of 4 chunks of 2·16 terms; each IPA round of s terms a
    # chunk: 2 shards of its L-R MSM (8 of the 16 groups each), then one fold
    # of the bases where half a round is more than one term
    nm = RANGE_D // RANGE_CHUNKS * RANGE_BITS
    assert ladders == [4 * 2 * nm] * 2 + sum(
        ([8 * s] * 2 + ([8 * s] if s > 2 else []) for s in (16, 8, 4, 2)), [])

    mesh3 = pmesh.param_mesh(3, [CPU] * 3)
    ok = rpv.verify_rangeproof(proofs, commits, fp, RANGE_BITS,
                               np.random.default_rng(SEEDS["range_verify"]), mesh3)
    raw = bytearray(proofs[FLIP_PROOF].to_bytes())
    raw[FLIP_BYTE] ^= 1
    bad = proofs[:FLIP_PROOF] + [RP.RangeProof.from_bytes(bytes(raw))] + proofs[FLIP_PROOF + 1:]
    bad_ok = rpv.verify_rangeproof(bad, commits, fp, RANGE_BITS,
                                   np.random.default_rng(SEEDS["range_verify"]), mesh3)
    assert (ok, bad_ok) == (KAT["ok"], KAT["flipped_ok"]) == (True, False)
