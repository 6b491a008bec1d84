"""The two loops that a traffic file can ask for, and the check of what each
timed. A loop gets the configuration and the traffic as dicts, the seed and
the device; ``setup`` builds and warms it, ``window`` runs whole steps until
the seconds have passed, ``release`` frees the program's state, ``check``
returns the numbers compared, each with its limit.

  client  one client proves updates back to back: a step is
          ``fl.params.encrypt`` then ``serialize``, from the plaintext
          update to the upload's bytes.
  server  the server's round path (``fl.server.TrainingState``, no
          transport): every round hands it the same K uploads, made in
          set-up, through ``start_update`` in client order, and ends with
          the extract and the model update. Each round deserializes and
          verifies its bytes anew.

A program option a control run switches on: ``fp_frac_delta`` lowers the
program's fixed-point precision by that many fractional bits (the check
keeps the configuration's).
"""

from __future__ import annotations

import asyncio
import contextlib
import shutil
import tempfile
import time

import numpy as np
import torch

from ..reference import fixed_point as fxp
from ..reference import verify as ref
from ..reference.wire import ENC_NORM_DATA, ENC_RANGE_DATA, parse_upload
from . import inputs


def sync(device) -> None:
    """Wait for the card (nothing to wait for on the CPU)."""
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _crypto_config(P, cfg: dict, fp_frac_delta: int = 0):
    from rofl_tpu_torch.crypto.fp_codec import FpConfig

    enc_type = {"l2": P.ENC_L2_TYPE, "range": P.ENC_RANGE_TYPE}[cfg["enc_type"]]
    return P.CryptoConfig(value_range=cfg["value_range"], n_partition=cfg["n_partition"],
                          l2_value_range=cfg["l2_value_range"],
                          check_percentage=cfg["check_percentage"], enc_type=enc_type,
                          fp=FpConfig(cfg["fp_bits"], cfg["fp_frac"] - fp_frac_delta))


def _span_layers(rec, P) -> None:
    """The layers' entry points as fl/params.py reaches them."""
    from rofl_tpu_torch.crypto import l2_range_proof as L2RP
    from rofl_tpu_torch.crypto import range_proof_vec as RPV
    from rofl_tpu_torch.crypto import sigma
    from rofl_tpu_torch.ops import kernels

    rec.span(RPV, "create_rangeproof", "range_prove")
    rec.span(L2RP, "create_rangeproof_l2", "range_prove")
    rec.span(sigma, "square_rand_proof_prove", "sigma_prove")
    rec.span(sigma, "rand_proof_prove", "sigma_prove")
    for cls in (P.EncParamsL2, P.EncParamsRange):
        rec.span(cls, "serialize", "serialize")
    rec.span(P, "deserialize", "deserialize")
    rec.span(RPV, "verify_rangeproof", "range_verify")
    rec.span(L2RP, "verify_rangeproof_l2", "range_verify")
    rec.span(sigma, "square_rand_proof_verify_batched", "sigma_verify")
    rec.span(sigma, "rand_proof_verify", "sigma_verify")
    rec.span(P.Accumulator, "accumulate", "accumulate")
    rec.span(P.Accumulator, "extract", "extract")
    rec.shapes(kernels, "msm_groups", "msm", lambda k, p, group: (p[0].shape[-1], group))
    rec.shapes(kernels, "msm_flat", "msm", lambda k, p: (p[0].shape[-1], p[0].shape[-1]))
    rec.shapes(kernels, "scalar_mul", "scalar_mul", lambda k, p: p[0].shape[-1])


def _no_interval(name):
    return contextlib.nullcontext()


def _nothing():
    pass


class ClientLoop:
    # set by a traced run: a step's stretch of host time, labelled for the
    # trace, and what to do after each step
    interval = staticmethod(_no_interval)
    after_step = staticmethod(_nothing)

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, fp_frac_delta: int = 0):
        from rofl_tpu_torch.fl import params as P

        self.P, self.cfg, self.traffic, self.seed, self.device = P, cfg, traffic, seed, device
        self.cc = _crypto_config(P, cfg, fp_frac_delta)
        self.uploads: list[bytes] = []
        self.steps = 0
        self.window_s = 0.0
        self.step_s: list[float] = []

    def span_layers(self, rec) -> None:
        _span_layers(rec, self.P)

    def _step(self, index: int) -> bytes:
        x = inputs.update(self.cfg, self.seed, index)
        blind = inputs.to_device(inputs.blinding_limbs(self.cfg["d"], self.seed, index),
                                 self.device)
        with self.interval("step"):
            enc = self.P.encrypt(self.cc.enc_type, x, blind, self.cc,
                                 inputs.rng(self.seed, inputs.PROGRAM, index), self.device)
            data = enc.serialize()
        sync(self.device)
        return data

    def setup(self) -> None:
        for i in range(self.traffic["warmup_steps"]):
            self._step(-1 - i)

    def window(self, seconds: float) -> None:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            ts = time.perf_counter()
            self.uploads.append(self._step(self.steps))
            self.step_s.append(time.perf_counter() - ts)
            self.steps += 1
            self.after_step()
        self.window_s = time.perf_counter() - t0

    def counts(self) -> dict:
        return {"attempted": self.steps, "failed": 0, "steps": self.steps}

    def release(self) -> None:
        pass

    def check(self) -> dict:
        """The upload of a step drawn from the seed, checked whole."""
        pick = inputs.rng(self.seed, inputs.CHECK)
        index = int(pick.integers(0, max(1, self.steps)))
        fails = ref.check_upload(self.cfg, self.uploads[index],
                                 inputs.update(self.cfg, self.seed, index),
                                 inputs.limbs_to_ints(inputs.blinding_limbs(
                                     self.cfg["d"], self.seed, index)),
                                 pick, self.device)
        return {name: (value, 0) for name, value in fails.items()}


class ServerLoop:
    interval = staticmethod(_no_interval)
    after_step = staticmethod(_nothing)

    def __init__(self, cfg: dict, traffic: dict, seed: int, device, fp_frac_delta: int = 0):
        from rofl_tpu_torch.fl import params as P
        from rofl_tpu_torch.fl import server as S

        self.P, self.S = P, S
        self.cfg, self.traffic, self.seed, self.device = cfg, traffic, seed, device
        self.cc = _crypto_config(P, cfg, fp_frac_delta)
        self.k = traffic["clients"]
        self.rounds = 0
        self.window_s = 0.0
        self.step_s: list[float] = []
        self.extracted: list = []
        self.refused = 0
        self.control_accepted = None
        self.loop = asyncio.new_event_loop()
        self.bench_dir = tempfile.mkdtemp(prefix="portbench-")
        self.state = None

    def span_layers(self, rec) -> None:
        _span_layers(rec, self.P)

    def setup(self) -> None:
        d = self.cfg["d"]
        self.updates = [inputs.update(self.cfg, self.seed, k) for k in range(self.k)]
        blinds = inputs.cancelling_blindings(d, self.k, self.seed)
        self.uploads = [
            self.P.encrypt(self.cc.enc_type, x, inputs.to_device(b, self.device), self.cc,
                           inputs.rng(self.seed, inputs.PROGRAM, k), self.device).serialize()
            for k, (x, b) in enumerate(zip(self.updates, blinds))]
        self.model0 = (inputs.rng(self.seed, inputs.MODEL).standard_normal(d) * 0.05
                       ).astype(np.float32)
        self.state = self.S.TrainingState(self.S.ServerConfig(
            num_clients=self.k, num_params=d, num_rounds=1 << 30,
            learning_rate=self.cfg["learning_rate"], enc_type=self.cc.enc_type,
            crypto=self.cc, verification_threads=self.traffic["verification_threads"],
            lazy_verification=False, initial_model=self.model0, write_model_file=False,
            bench_dir=self.bench_dir, device=self.device))
        self.state.status = "in_progress"
        self.state.start_new_round(0)
        for _ in range(self.traffic["warmup_rounds"]):
            self._round(self.uploads, record=True)

    def _round(self, uploads, record: bool) -> bool:
        """One round through the server's own entry; True where it ended
        with a model update."""
        state = self.state

        async def go():
            r = state.current_round()
            with self.interval("round"):
                for k, data in enumerate(uploads):
                    state.start_update(k, data)
                tasks = list(state.update_tasks)
                results = await asyncio.gather(*tasks, return_exceptions=True)
            return r, any(isinstance(x, BaseException) for x in results)

        r, raised = self.loop.run_until_complete(go())
        sync(self.device)
        ok = not raised and r.extracted is not None and r.is_done()
        if record:
            self.extracted.append(None if r.extracted is None else r.extracted.copy())
            if not ok:
                self.refused += len(uploads)
        return ok

    def window(self, seconds: float) -> None:
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            ts = time.perf_counter()
            if not self._round(self.uploads, record=True):
                break
            self.step_s.append(time.perf_counter() - ts)
            self.rounds += 1
            self.after_step()
        self.window_s = time.perf_counter() - t0

    def counts(self) -> dict:
        return {"attempted": self.rounds * self.k, "failed": self.refused,
                "steps": self.rounds * self.k, "rounds": self.rounds}

    def release(self) -> None:
        """Run the control round (the last upload's first range proof with
        one bit flipped: the round must not end with a model update), then
        free the server."""
        self.model_after = self.state.global_model.copy()
        if self.refused == 0:
            bad = tampered(self.uploads[-1], self.cfg["enc_type"])
            self.control_accepted = int(self._round(self.uploads[:-1] + [bad], record=False))
            self.model_unchanged = bool(np.array_equal(self.state.global_model, self.model_after))
        self.state.close()
        self.state = None
        self.loop.close()
        shutil.rmtree(self.bench_dir, ignore_errors=True)
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        """Every round's extracted sum against the fixed-point sum of the
        plaintexts, and the model after the window against the same rounds
        replayed; honest uploads refused; the tampered upload accepted."""
        cfg = self.cfg
        want = fxp.server_sum(self.updates, cfg["fp_bits"], cfg["fp_frac"], cfg["value_range"])
        gap = 0.0
        model = self.model0
        for got in self.extracted:
            if got is None:
                gap = float("inf")
                break
            gap = max(gap, float(np.max(np.abs(got.astype(np.float64) - want))) *
                      (1 << cfg["fp_frac"]))
            model = fxp.next_model(model, want, self.k, cfg["learning_rate"])
        model_gap = float(np.max(np.abs(model.astype(np.float64) - self.model_after)))
        accepted = 1 if self.control_accepted is None else self.control_accepted
        if self.control_accepted == 0 and not self.model_unchanged:
            accepted = 1
        return {"honest_uploads_refused": (self.refused, 0),
                "sum_max_gap_units": (gap, 0),
                "model_max_gap": (model_gap, 0),
                "tampered_upload_accepted": (accepted, 0)}


def tampered(data: bytes, enc_type: str) -> bytes:
    """The upload with the lowest bit of its first range proof's
    t_x_blinding flipped."""
    schema = ENC_NORM_DATA if enc_type == "l2" else ENC_RANGE_DATA
    first = parse_upload(data, schema)["range_proof"][0]
    at = data.index(first) + 5 * 32
    out = bytearray(data)
    out[at] ^= 1
    return bytes(out)


LOOPS = {"client": ClientLoop, "server": ServerLoop}
