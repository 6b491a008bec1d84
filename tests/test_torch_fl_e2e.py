"""An encrypted FL round of the port end to end on the CPU: server and
clients over gRPC, the port's counterparts of
``tests/test_fl_e2e.py``'s EncRange round and tampered upload.

EncRange, 2 clients, d = 4, value range 8, one partition, ``FpConfig(16, 7)``,
cancelling blindings from the port's ``pedersen``. DummyTrainer's 0.001
rounds to 0 at 7 fractional bits, so the extracted sum is the one unit that
the accumulator's (B, B) start adds, and the model is 1/128 / 2, as the JAX
package's test expects. A byte flipped in the middle of one client's upload
fails the round and leaves the model at zeros
(``test_torch_fl_e2e_tampered.py``: a file of its own, so that
``--dist loadfile`` gives the two tests of minutes two workers). Each port
encrypt at d = 4 is plain torch on the CPU (tens of seconds; the two
clients' run one after the other), and the server's extract builds the BSGS table of 2^16 entries
(``server.BSGS_TABLE_SIZE``) once, about 45 s. Tolerance: the JAX test's
1e-6 on the model; the extracted sum exact."""

import numpy as np

from rofl_tpu_torch.crypto import pedersen
from rofl_tpu_torch.fl import params as P
from rofl_tpu_torch.fl import wire
from rofl_tpu_torch.fl.server import ServerConfig
from torch_port_fl import cancelling_fns, run_fl

N_PARAMS = 4
N_CLIENTS = 2


def enc_range_cfg() -> ServerConfig:
    return ServerConfig(
        model_id=1, num_clients=N_CLIENTS, num_params=N_PARAMS, num_rounds=1,
        learning_rate=1.0, enc_type=P.ENC_RANGE_TYPE, write_model_file=False, bench_dir=None,
        crypto=P.CryptoConfig(value_range=8, n_partition=1, enc_type=P.ENC_RANGE_TYPE),
        device="cpu")


def blindings(seed: int):
    rng = np.random.default_rng(seed)
    return cancelling_fns({0: pedersen.cancelling_scalar_limbs(N_CLIENTS, N_PARAMS, rng, "cpu")})


def test_enc_range_round_with_cancelling_blindings():
    state, clients = run_fl(enc_range_cfg(), N_CLIENTS, blinding_fns=blindings(55),
                            encrypt_threads=1)
    assert state.status == "done"
    np.testing.assert_array_equal(state.rounds[0].extracted,
                                  np.full(N_PARAMS, 1 / 128, np.float32))
    expected = np.float32(1 / 128) / N_CLIENTS
    np.testing.assert_allclose(state.global_model, np.full(N_PARAMS, expected, np.float32),
                               atol=1e-6)
    assert [c.done_status for c in clients] == [wire.STATUS_DONE] * N_CLIENTS
    sizes = {c.round_log[0]["sent_bytes"] for c in clients}
    assert len(sizes) == 1 and all(c.round_log[0]["blocks"] == 1 for c in clients)

