"""Runs the port's FL server and clients in one event loop, over gRPC on
127.0.0.1 (an ephemeral port). Shared by the FL tests on the
CPU and on the card; imports only the port."""

import asyncio
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from rofl_tpu_torch.crypto import compressed_rand_proof as CRP
from rofl_tpu_torch.crypto import sigma
from rofl_tpu_torch.fl import params as P
from rofl_tpu_torch.fl.client import FlServiceClient
from rofl_tpu_torch.fl.server import TrainingState, make_server
from rofl_tpu_torch.fl.trainclient import DummyTrainer


def flip_middle_byte(client: FlServiceClient) -> None:
    """Make `client` corrupt a byte in the middle of each serialized upload."""
    encrypt = client._encrypt

    def tampered(update, round_id):
        data = bytearray(encrypt(update, round_id))
        data[len(data) // 2] ^= 0x55
        return bytes(data)

    client._encrypt = tampered


def flipped_rand_proof(enc, lane: int = 0):
    """`enc` with the lowest bit of its rand proof's z_m flipped: lane
    `lane`'s in EncRange, the one z_m of the compressed modes' proof. The
    upload still parses and its commitments are untouched, so only its
    verification fails."""
    if isinstance(enc, P.EncParamsRange):
        z_m = enc.rand_proofs.z_m.clone()
        z_m[0, lane] ^= 1
        proofs = sigma.RandProofVec(enc.rand_proofs.c_prime, z_m, enc.rand_proofs.z_r)
        return P.EncParamsRange(enc.enc_values, proofs, enc.range_proofs, enc.prove_range,
                                enc.check_percentage, enc.fp)
    proof = enc.rand_proof
    bad = CRP.CompressedRandProof(proof.c_prime_L, proof.c_prime_R, proof.z_m ^ 1, proof.z_r)
    return type(enc)(**dict(enc.__dict__, rand_proof=bad))


def flip_rand_proof(client: FlServiceClient, round_id: int) -> None:
    """Make `client` upload, in round `round_id` only, an update whose rand
    proof has one bit flipped (``flipped_rand_proof``)."""
    def tampered(update, r):
        enc = P.encrypt(client.enc_type, update, client._blindings(r, len(update)),
                        client.crypto_cfg, client.rng, client.device)
        return (flipped_rand_proof(enc) if r == round_id else enc).serialize()

    client._encrypt = tampered


def run_fl(cfg, n_clients: int, blinding_fns=None, tampered=(), timeout=600.0,
           encrypt_threads=None, tamper_round=None):
    """One server and `n_clients` DummyTrainer clients on ``cfg.device``
    until the server is done or has failed; returns (state, clients).
    Clients still waiting when the server failed are cancelled. The clients
    encrypt on the loop's default executor; `encrypt_threads` gives it that
    many threads (the clients share one interpreter, and on the CPU two
    encrypts at once take longer than one after the other). The clients in
    `tampered` flip a byte in the middle of every upload, or with
    `tamper_round` a bit of their rand proof in that round only."""

    async def main():
        if encrypt_threads:
            asyncio.get_running_loop().set_default_executor(ThreadPoolExecutor(encrypt_threads))
        state = TrainingState(cfg)
        server = make_server({cfg.model_id: state}, "127.0.0.1:0")
        await server.start()
        address = f"127.0.0.1:{server.port}"
        clients = [FlServiceClient(address, cfg.model_id, i, DummyTrainer(),
                                   blinding_fn=blinding_fns[i] if blinding_fns else None,
                                   device=cfg.device) for i in range(n_clients)]
        for i, client in enumerate(clients):
            client.rng = np.random.default_rng(i)  # the proofs' randomness, seeded
        for i in tampered:
            if tamper_round is None:
                flip_middle_byte(clients[i])
            else:
                flip_rand_proof(clients[i], tamper_round)
        tasks = [asyncio.create_task(c.train_model()) for c in clients]
        try:
            await asyncio.wait_for(state.done_event.wait(), timeout)
            if state.status == "done":
                await asyncio.wait_for(asyncio.gather(*tasks), timeout)
        finally:
            for t in tasks:
                t.cancel()
            await asyncio.gather(*tasks, return_exceptions=True)
            await server.stop(0.5)
            state.close()
        return state, clients

    return asyncio.run(main())


def cancelling_fns(per_round: dict):
    """blinding_fn of each client from {round: [one (16, d) array a client]}."""
    n_clients = len(next(iter(per_round.values())))
    return [lambda round_id, n, i=i: per_round[round_id][i] for i in range(n_clients)]
