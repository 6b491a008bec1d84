"""A whole run of a cell on the CPU at a tiny size (the card's look skipped),
honest, under the control, and with the timed path broken underneath: the
check must pass the first and fail every other. Several minutes of plain
torch; run apart from the repository's tier-1 tests:

    python -m pytest portbench/tests/test_portbench_faults.py -q
"""

from __future__ import annotations

import json

import numpy as np
import pytest

from portbench import run as R
from portbench.harness import bench as B

SEED = 2**31 + 77


def _cell(workload: str, **traffic):
    spec = B.load_benchmark()
    cell = B.cell(spec, workload)
    cfg = dict(B.config(spec, cell["config"]), d=2, n_partition=2)
    tr = dict(B.traffic(cell["traffic"]), **traffic)
    return cfg, tr


def _run(workload: str, fp_frac_delta: int = 0, **traffic) -> dict:
    cfg, tr = _cell(workload, **traffic)
    result, _ = R.run_cell(workload, SEED, 0.01, False, device="cpu",
                           fp_frac_delta=fp_frac_delta, config=cfg, traffic=tr)
    json.dumps(result)
    return result


# -- client ---------------------------------------------------------------------


def _stale_upload(monkeypatch, P):
    """Every step returns the first upload it made (its state unchanged)."""
    first = []
    real = P.encrypt

    def encrypt(*args, **kwargs):
        if not first:
            first.append(real(*args, **kwargs))
        return first[0]

    monkeypatch.setattr(P, "encrypt", encrypt)


def _half_the_lanes(monkeypatch, P):
    """Half of the update left out: only its first half is proved."""
    real = P.encrypt

    def encrypt(enc_type, x, blind, *args, **kwargs):
        h = len(x) // 2
        return real(enc_type, x[:h], blind[:, :h].contiguous(), *args, **kwargs)

    monkeypatch.setattr(P, "encrypt", encrypt)


def _flipped_byte(monkeypatch, P):
    """An answer altered where it is produced: one byte of the upload."""
    real = P.EncParamsL2.serialize

    def serialize(self):
        data = bytearray(real(self))
        data[len(data) // 3] ^= 0x10
        return bytes(data)

    monkeypatch.setattr(P.EncParamsL2, "serialize", serialize)


@pytest.mark.parametrize("fault", [None, _stale_upload, _half_the_lanes, _flipped_byte])
def test_client_cell_faults(monkeypatch, fault):
    from rofl_tpu_torch.fl import params as P

    if fault is not None:
        fault(monkeypatch, P)
    result = _run("l2_d50k.client", warmup_steps=1)
    assert result["correct"] is (fault is None), result["checks"]


def test_client_cell_control_at_lower_precision():
    result = _run("l2_d50k.client", fp_frac_delta=1, warmup_steps=0)
    assert result["correct"] is False
    assert result["checks"]["commitments_and_sigma"]["value"] > 0


# -- server ---------------------------------------------------------------------


def _state_unchanged(monkeypatch, P, S):
    """accumulate() reports success and adds nothing."""
    monkeypatch.setattr(P.Accumulator, "accumulate", lambda self, params: True)


def _half_the_batch(monkeypatch, P, S):
    """A round closes on half of its uploads, the mean taken over them."""
    real = S.TrainingRoundState.__init__
    half = []

    def init(self, round_id, expected_clients, cfg):
        half.append(half[0] if half else max(1, expected_clients // 2))
        real(self, round_id, half[0], cfg)
        cfg.num_clients = half[0]

    monkeypatch.setattr(S.TrainingRoundState, "__init__", init)


def _altered_sum(monkeypatch, P, S):
    """An answer altered where it is produced: one extracted value."""
    real = P.Accumulator.extract

    def extract(self):
        out = real(self)
        if out is not None:
            out = out.copy()
            out[0] += np.float32(1 / 128)
        return out

    monkeypatch.setattr(P.Accumulator, "extract", extract)


@pytest.mark.parametrize("fault", [None, _state_unchanged, _half_the_batch, _altered_sum])
def test_server_cell_faults(monkeypatch, fault):
    from rofl_tpu_torch.fl import params as P
    from rofl_tpu_torch.fl import server as S

    if fault is not None:
        fault(monkeypatch, P, S)
    result = _run("range_d62006.server", clients=2, warmup_rounds=0)
    assert result["correct"] is (fault is None), result["checks"]
    if fault is None:
        assert result["checks"]["tampered_upload_accepted"]["value"] == 0


def test_server_cell_control_at_lower_precision():
    result = _run("range_d62006.server", fp_frac_delta=1, clients=2, warmup_rounds=0)
    assert result["correct"] is False
    assert result["checks"]["sum_max_gap_units"]["value"] > 0
