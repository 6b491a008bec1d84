"""A tampered upload fails an encrypted FL round of the port on the CPU:
the settings of ``test_torch_fl_e2e.py`` (EncRange, 2 clients, d = 4), with
a byte flipped in the middle of client 1's upload; the round fails and the
model stays at zeros. A file of its own so that ``--dist loadfile`` gives
it a worker apart from the honest round's (each takes minutes: port
encrypts in plain torch)."""

import numpy as np

from test_torch_fl_e2e import N_CLIENTS, N_PARAMS, blindings, enc_range_cfg
from torch_port_fl import run_fl


def test_a_tampered_upload_fails_the_round():
    state, clients = run_fl(enc_range_cfg(), N_CLIENTS, blinding_fns=blindings(99),
                            tampered=(1,), encrypt_threads=1)
    assert state.status == "failed"
    np.testing.assert_array_equal(state.global_model, np.zeros(N_PARAMS, np.float32))
    assert all(c.done_status is None for c in clients)
