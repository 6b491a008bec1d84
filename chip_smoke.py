"""Drive the PyTorch/CUDA port once on the card: build the kernels, hold each
against its plain version, run the secure-aggregation round, the Σ-protocol
path (prove → wire → per-lane verify), the L2-norm client round
(encrypt → wire → verify), the server's round in the other encrypted
modes (encrypt → wire → verify → accumulate → extract), the device mesh
(the sharded data plane, the mesh-routed provers and verifiers, the
multi-device dry run and the scaling table), the FL runtime
(a server and four clients over gRPC) at full width, the
training path (a YAML experiment with trainer services on the card), the
micro-benchmark suite, and the e2e suite with every role in its own process.

    python3 chip_smoke.py

needs one NVIDIA GPU (built for sm_90a: an H100), `nvcc`, and nothing else.
It imports only ``rofl_tpu_torch`` (and two helpers of its tests that import
only the port). Every phase prints one JSON line; the
first failure of any phase ends the run with a non-zero exit code. The last
line is ``{"ok": true, "device": {...}}``.

Phases:
  device   the card's name and power limit, torch and CUDA versions, and
           whether grpc, google.protobuf and yaml could be imported there;
           fails without grpc, the FL runtime's transport
  build    nvcc builds the kernels of the fifteen wrappers from the fourteen
           sources in rofl_tpu_torch/csrc (in parallel) and reports ptxas'
           registers, spill bytes and shared memory for each entry point
  compress_first
           compress against its plain version and the spec before any check
           reads a point through it: every representative of random points
           and the basepoint (both sides of its rotate and negate-y selects),
           the identity as (0 : s : s : 0) with every limb 2^16 - 1 and as
           the torsion points, coordinates raised into [p, 2^256), at N = 1,
           77 and 50000, and what the 32-bit point_add (a broadcast lane on
           either side too), scalar_mul and msm_groups leave; point_add on
           the same edge inputs, point_double on every input of compress
  decompress_edges
           decompress against its plain version (mask, canonical
           coordinates, z as canonical 1) and its mask against the spec's
           decoding of s mod p, before it is timed: s = 0, 1, p - 1, every s
           in [p, 2^255), s with bit 255 set, odd s, non-squares, the
           encodings whose y is 0 and valid ones, alone and tiled to N = 1,
           77 and 50000
  kernels  point_add, point_double, compress, decompress, sc_reduce_wide,
           sc_mul, sc_add, sc_sub, scalar_mul, msm_flat, msm_groups,
           shared_scalar_mul, scalar_mul_window, point_sum, sc_sum against their plain torch
           versions on the card, at the lane counts the paths use and at
           N = 1 and 77, random and edge inputs, canonical limbs bit-equal
           (the ladders, the MSMs: canonical encodings of the results; their
           scalars include 2^256 - 1 and those whose signed digits are all
           the lowest, at radix 16 and at the MSM's window);
           times at N = 50000; the MSMs also held equal and timed, with
           their plain versions, at the l2 path's shapes, with the window c
           and the slices each ran at; shared_scalar_mul
           at N = 50000 for k = 0, 1, 2, l-1, 2^256 - 1 and scalars of low,
           high and random Hamming weight, each timed beside the nonzero
           digits of its width-5 NAF; scalar_mul_window at W = 2 and 4, per
           lane and broadcast; point_sum and sc_sum at the paths' layouts
           (outer, R, inner) (check_sums: tree_sum of d, the provers' A sums,
           the IPA's groups, the clients' sums, the range verifier's chunk
           sums, a ragged length), sc_sum bit-equal, point_sum as encodings,
           each timed beside its plain version and the halving chain of
           point_add / sc_add launches it replaced
  round    d = 50000, 4 clients, FpConfig(16, 7), through ``bindings``:
           cancelling blindings (keyed Keccak XOF on the card, reduced mod l
           by sc_reduce_wide) -> commit -> add_commitments -> extract_values
           with the default table (m = 2^16); the ElGamal-pair form of the
           same round through the wire format; an extract with a small table
           (m = 2^12) on 4096 lanes, which walks 16 giant steps. Sums are
           held against numpy's fixed-point sum, exactly.
  sigma    d = 50000, FpConfig(16, 7): rand proofs and square-rand proofs
           through ``bindings`` (create -> split / join -> verify), square
           proofs through ``crypto.sigma``, the ``existing=`` form on the
           round's own commitments; tampered proofs must be refused, lane by
           lane; the first lanes of each proof are recomputed by the
           pure-Python spec (spec/merlin.py, spec/ristretto.py) and held equal
           byte for byte; the transcripts are timed apart.
  l2       d = 50000, bench.py's headline configuration (16 partitions, value
           range 8, L2 range 16, FpConfig(16, 7), its element scale, seed 7):
           EncParamsL2.encrypt -> serialize -> deserialize -> verify, once to
           warm up and once timed, printed as l2_path_prove_verify_s_d50000
           with its parts, each stage also timed apart; a flipped bit in one
           chunk's range proof and a tampered square-rand lane are refused,
           values out of the L2 bound raise, the JAX package's committed
           known-answer round (tests/data/torch_port_l2_kat.json) verifies on
           the card and a small round made on the card verifies on the CPU.
  modes    d = 50000, FpConfig(16, 7), value range 8, 16 partitions, L2
           range 16, check_percentage 1.0: for each of EncRange,
           EncRangeCompressed and EncL2Compressed, 3 clients with cancelling
           blindings and nonzero values inside the proven range (and, for
           EncL2Compressed, inside the L2 bound) run encrypt -> serialize ->
           deserialize -> verify -> Accumulator.accumulate, then one extract,
           held equal to numpy's fixed-point sum (plus the one unit the
           accumulator's (B, B) start adds, as in the JAX package);
           <mode>_prove_verify_s_d50000 for the last client; a flipped rand
           proof or compressed proof is refused, an accumulator of two of
           the three clients extracts None, and one EncRange client at
           check_percentage 0.5 verifies after its wire round trip.
  mesh     the device mesh (``parallel.mesh``) at d = 50000, FpConfig(16, 7),
           16 partitions, range 8, L2 range 16, on a virtual mesh of the
           card (cuda:0 four times, and three times for the lane counts that
           do not divide) and on ``param_mesh()`` over every card: (a)
           sharded_msm of the l2 verifier's 300 000 terms and of their first
           50 000 (padded by 2 at 3 shards) equals msm.msm, encoding for
           encoding; (b) one EncParamsL2 update verifies with the mesh (its
           range proofs' combined MSM sharded), timed beside the same verify
           without it (mesh_l2_verify_s_d50000), a flipped range-proof bit
           is refused, and create_rangeproof with the mesh gives the bytes it
           gives without; (c) the rand and square-rand proofs over 3 shards
           equal the unsharded ones (responses, encodings) and verify over
           the shards; (d) ``parallel.dryrun.dryrun_multichip`` on a 2 x 2
           mesh of the card: stage 1 at the JAX dry run's shapes, stages 2-5
           at d = 50000 with the 2^16 BSGS table; stage 1's commitments of
           the JAX package's updates equal the JAX mesh's
           (tests/data/torch_port_mesh_kat.json) and the port's updates are
           within a fixed-point unit of them; (e) ``scaling_table.main`` at
           --d 50000 --parts 16 over 1, 2 and 4 shards, its rows on a line
           of their own. Launches count the mesh-routed calls and the dry
           run, not the unsharded calls they are held against.
  fl       the FL runtime end to end: one server (``fl.server``: TrainingState,
           make_server) and 4 ``FlServiceClient``s and an ``FLObserver`` in
           one event loop over gRPC (``fl/transport.py``) on 127.0.0.1 (an
           ephemeral port); EncL2, 16 partitions, value range 8, L2 range 16,
           check_percentage 1.0, FpConfig(16, 7), 1 round (cut from 2), eager
           verification on one thread, the clients' encrypts one at a time
           (the loop's default executor has one thread: four at once in one
           interpreter thrash the GIL); the initial global model is
           models/resnet18_intrinsic_50k.txt (d = 50000); cancelling
           blindings a round; each client's trainer returns seeded updates of
           0 or +-1 unit of 2^-7. Each round's extracted sum is held equal to
           numpy's fixed-point sum of the four updates plus the accumulator's
           one unit, the final model bit-equal to the numpy float32 replay of
           the server's update rule, every client ends with DONE and the
           observer sees every broadcast. Prints fl_round_s_d50000 (the
           server's time from a round's model broadcast to the next broadcast
           or DONE), the server's and each client's stage times, the upload
           bytes and DataBlocks, peak device memory. Then one round in which
           client 1 flips a byte in the middle of its upload: the server must
           end failed with the model unchanged.
  train    the training path through the functions the CLI's commands call
           (``cli.make_train_service``, ``cli.make_evaluator``, the
           server's ``load_experiment``), in one event loop: (a)
           configs/mnist_range_e2e.yml (EncRange, 16 partitions, d = 5000,
           the z-vector models/mnist_dev_intrinsic_5k.txt) cut from 5 rounds
           to 1 (2 before), four ``TorchTrainService``s (client i trains
           ``mnist_dev_intrinsic`` on shard i at the CLI's defaults: lr 0.1,
           batch 32, one epoch; θ = θ0 + P·z, D = 19 090) reached by four
           clients through ``GrpcTrainer`` over gRPC, zero
           blindings as ``cli clients``, eager verification on the CLI's 4
           threads, an observer that evaluates with a ``Trainer``; every
           update finite and nonzero, each extracted sum the clients'
           fixed-point sum plus the accumulator's one unit, the final model
           bit-equal to numpy's replay, the observer's loss finite each
           round. Prints the round seconds, the trainer's ms a round and a
           step apart (the generation of P, the projections, the network's
           forward and backward, the update), the server's and clients'
           stage ms, the observer's loss and accuracy, peak memory. (b)
           configs/mnist_l2_compressed.yml with lazy verification and
           ``DummyTrainService``s, 2 clients (cut from 4) and 2 honest
           rounds (cut from 5; lazy verification needs the second); (c)
           the same with client
           1's rand proof flipped in round 0: the run fails at round 1's
           finalize, after round 0's update was applied. Then θ0 of
           mnist_dev and one intrinsic SGD step at d = 5000 on the card
           against the JAX package's (tests/data/torch_port_models_kat.npz).
  micro    ``bench_suite.main`` in this process: all 11 benches at d = 32768
           (the reference's first dimension), one sample each after its
           warm-up, FpConfig(16, 7), range 8, into a temporary directory;
           every verify sample must accept (they raise otherwise), and each
           of the 16 files must hold one integer line. l2rangeproof runs at
           d = 128: its values' squared sum exceeds the L2 bound above
           d = 160 (reference hazard 14), and at 32768 it must raise
           L2NormError, as the JAX bench does. Prints each bench's
           ms as a float beside the card's name and power limit.
  e2e      ``run_e2e_suite.main`` with the JAX suite's default modes (Plain,
           Range, l2Compressed) on configs/example_config.yml (mnist_dev, all
           19 090 parameters), 4 clients, 1 trainer service and the observer,
           cut from the suite's 3 rounds to 2, free ports, a temporary
           --out: for each mode ``run_e2e`` starts the server, the trainer
           service (``TorchTrainService``), the observer and one ``clients``
           process, each ``python -m rofl_tpu_torch.cli --device cuda`` on
           this card. Each server must exit 0 before the timeout, each
           client's .bench hold 2 lines, the accuracy be parsed, Range and
           l2Compressed send more bytes than Plain, and no child's process
           group be left, on the card or off it. ``nvidia-smi`` is sampled
           every second: at least 4 compute processes that were not there
           before the phase, or, where the container hides their pids, the
           card's memory in use at least 1.5 GB above what it was before
           (this process's); the line says which it read. Prints the table, each
           mode's seconds, the children's peak memory; their kernel launches
           are in their processes and not counted here.
Every phase line carries ``phase_s``, the seconds since the line before it;
a line before the ``kernels`` line gives them all and their total.
Launch counts and lanes launched (the sum of N over a kernel's launches) are
set to zero just before each path (for l2: its timed run; for modes: each
mode's three clients and the extract; for mesh: the mesh-routed calls of
(a)-(c) and the dry run; for fl: the honest round, not the
tampered one; for train: run (a), not (b), (c) or the KAT check; for micro:
the suite) and
read just after it; each path's
line prints both. shared_scalar_mul and scalar_mul_window are on no path of either
package's defaults (the JAX package never calls the first and runs the
second only under ROFL_SMUL_W > 1): their launches are 0 on every path.
"""

from __future__ import annotations

import asyncio
import contextlib
import hashlib
import importlib.metadata
import importlib.util
import io
import json
import math
import os
import re
import socket
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    sys.exit("chip_smoke.py needs a CUDA device: torch.cuda.is_available() is False")

from rofl_tpu_torch import bench_suite, bindings  # noqa: E402
from rofl_tpu_torch.crypto import l2_range_proof as L2RP  # noqa: E402
from rofl_tpu_torch.crypto import pedersen, sigma  # noqa: E402
from rofl_tpu_torch.crypto import range_proof as RP  # noqa: E402
from rofl_tpu_torch.crypto import range_proof_vec as RPV  # noqa: E402
from rofl_tpu_torch.crypto import serde_vec as sv  # noqa: E402
from rofl_tpu_torch.crypto.fp_codec import FpConfig  # noqa: E402
from rofl_tpu_torch.fl import params as P  # noqa: E402
from rofl_tpu_torch.fl import wire  # noqa: E402
from rofl_tpu_torch import cli  # noqa: E402
from rofl_tpu_torch.fl.client import FlServiceClient  # noqa: E402
from rofl_tpu_torch.fl.config import load_experiment  # noqa: E402
from rofl_tpu_torch.fl.observer import FLObserver  # noqa: E402
from rofl_tpu_torch.fl.server import ServerConfig, TrainingState, make_server  # noqa: E402
from rofl_tpu_torch.fl.trainclient import GrpcTrainer  # noqa: E402
from rofl_tpu_torch.fl.trainservice import DummyTrainService, make_train_server  # noqa: E402
from rofl_tpu_torch.fl.util import read_model_from_file  # noqa: E402
from rofl_tpu_torch.models import intrinsic, networks  # noqa: E402
from rofl_tpu_torch.models import trainer as trainer_mod  # noqa: E402
from rofl_tpu_torch.models.trainer import Trainer  # noqa: E402
from rofl_tpu_torch.ops import bsgs, curve, fe, fixed_base, kernels, msm, sc  # noqa: E402
from rofl_tpu_torch.ops.curve import PointArray  # noqa: E402
from rofl_tpu_torch.parallel import dryrun  # noqa: E402
from rofl_tpu_torch.parallel import mesh as pmesh  # noqa: E402
from rofl_tpu_torch.scripts import run_e2e_suite, scaling_table  # noqa: E402
from rofl_tpu_torch.spec import field as SF  # noqa: E402
from rofl_tpu_torch.spec import generators as G  # noqa: E402
from rofl_tpu_torch.spec import ristretto as SR  # noqa: E402
from rofl_tpu_torch.spec import scalar as SS  # noqa: E402
from rofl_tpu_torch.spec.merlin import Transcript  # noqa: E402

# The decompress edge inputs that the host tests and the tests on the card
# hold; the module imports only the port's spec.
sys.path.insert(1, str(Path(__file__).resolve().parent / "tests"))
from torch_port_edges import (  # noqa: E402
    DECOMPRESS_EDGE_CASES, decompress_edges, spec_decompress)
from torch_port_fl import flip_middle_byte, flip_rand_proof, flipped_rand_proof  # noqa: E402
from torch.func import functional_call  # noqa: E402

DEVICE = "cuda"
D = 50000
N_CLIENTS = 4
FP = FpConfig(16, 7)
SMALL_TABLE = 1 << 12
SMALL_LANES = 4096
SEED = 2024
# Client updates are whole multiples of 2^-7 in [-100, 100]: the fixed-point sum
# of four is exact and stays inside the 16-bit extraction range.
UPDATE_BITS = 12800

# Published peaks of one H100 SXM at its full 700 W limit (NVIDIA data sheet):
# 3.35 TB/s of HBM3, 67 TFLOP/s fp32 outside the tensor cores. An SM has half
# as many int32 lanes as fp32 lanes, so the 32-bit integer peak is taken as
# half the fp32 rate, a multiply-add counted as two operations.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 2

# 32-bit multiply-adds per lane, counted for the cheapest layout the card
# allows (every curve kernel runs on it): with 8 limbs of 32 bits a 255-bit
# product is 64 wide multiplies, each a low and a high 32-bit multiply-add,
# so 128, and a squaring is 36 wide multiplies, 72.
# Field operations the functions need, from the formulas in csrc/fe25519_32.cuh:
#   add        9 products
#   double     4 products + 4 squarings
#   invsqrt    16 products + 254 squarings (sqrt_ratio_m1 at u = 1, the only
#              u either encoding passes: no product by u)
#   compress   invsqrt + 10 products + 1 squaring, and 3 products more
#              (by sqrt(-1) twice and by 1/sqrt(a - d)) on the lanes that
#              rotate only: counted for the share of the timed points that
#              rotate (compress_rotated_share)
#   decompress invsqrt + 8 products + 3 squarings
# sc_reduce_wide folds 9, 5 and 2 words of 32 bits against the 4 words of
# 2^252 - l (csrc/sc25519.cuh): 64 wide multiplies, 128 multiply-adds.
# sc_mul is 64 wide multiplies for the 512-bit product and 64 for the folds:
# 256 multiply-adds. sc_add and sc_sub have no multiply: 8 word adds or
# subtracts with carry, 8 more for the correction by l and 8 selects, counted
# as 24 operations. scalar_mul is counted for the cheapest schedule of the same
# function for a secret k (least_ladder_madds): signed 5-bit windows, a table
# of P..16P (8 doublings, 7 adds), then 51 windows of 5 doublings (T left out
# of all but the last: 3 products and 4 squarings) and one add, 251 104
# multiply-adds; the kernel's signed radix-16 ladder does 260 608 (4-bit
# windows), a one-bit ladder 499 712. scalar_mul_window computes the same
# function and has the same bound.
# shared_scalar_mul's least work depends on its one scalar, which is known: its
# bound is computed per call (shared_bound_ms) from the cheapest fixed-window or
# NAF schedule for the scalar timed (T left out of every doubling that a
# doubling follows, as above), whatever the kernel runs (a width-5 NAF);
# k = 0 and k = 1 are bound by their bytes.
# Bytes per lane: (16, N) int32 arrays read and written once (the doubling
# reads no T), the validity byte of decompress, the 64 int32 byte columns of
# sc_reduce_wide.
MUL, SQR = 128, 72
LIMBS = 16 * 4
POINT_ADD_MADDS = 9 * MUL
POINT_DOUBLE_MADDS = 4 * MUL + 4 * SQR
POINT_DOUBLE_NO_T_MADDS = 3 * MUL + 4 * SQR  # a doubling followed by a doubling


def least_ladder_madds() -> int:
    """Multiply-adds of the cheapest signed-window schedule for k * P with
    k secret (every window added, whatever its digit): at window w, a table
    of 2^(w-1) multiples (half of them doublings, the rest adds of P), then
    ceil(257 / w) - 1 windows of w doublings (T only on the last) and one
    add, the top digit a table select."""
    costs = []
    for w in range(2, 9):
        half = 1 << (w - 1)
        table = half // 2 * POINT_DOUBLE_MADDS + (half // 2 - 1) * POINT_ADD_MADDS
        window = (w - 1) * POINT_DOUBLE_NO_T_MADDS + POINT_DOUBLE_MADDS + POINT_ADD_MADDS
        costs.append(table + (-(-257 // w) - 1) * window)
    return min(costs)


KERNEL_FACTS = {
    "point_add": dict(
        source="rofl_tpu_torch/csrc/point_add.cu", replaces="rofl_tpu/ops/kernels.py:428",
        madds=9 * MUL, bytes=12 * LIMBS),
    "point_double": dict(
        source="rofl_tpu_torch/csrc/point_double.cu", replaces="rofl_tpu/ops/kernels.py:433",
        madds=4 * MUL + 4 * SQR, bytes=7 * LIMBS),
    "compress": dict(
        source="rofl_tpu_torch/csrc/compress.cu", replaces="rofl_tpu/ops/kernels.py:639",
        madds=26 * MUL + 255 * SQR, bytes=5 * LIMBS),  # + 3 * MUL a rotating lane
    "decompress": dict(
        source="rofl_tpu_torch/csrc/decompress.cu", replaces="rofl_tpu/ops/kernels.py:675",
        madds=24 * MUL + 257 * SQR, bytes=5 * LIMBS + 1),
    "sc_reduce_wide": dict(
        source="rofl_tpu_torch/csrc/sc_reduce_wide.cu",
        replaces="rofl_tpu/ops/kernels.py:1153", madds=128, bytes=64 * 4 + LIMBS),
    "sc_mul": dict(
        source="rofl_tpu_torch/csrc/sc_mul.cu", replaces="rofl_tpu/ops/kernels.py:1133",
        madds=256, bytes=3 * LIMBS),
    "sc_add": dict(
        source="rofl_tpu_torch/csrc/sc_add.cu", replaces="rofl_tpu/ops/kernels.py:1193",
        madds=12, bytes=3 * LIMBS),
    "sc_sub": dict(
        source="rofl_tpu_torch/csrc/sc_sub.cu", replaces="rofl_tpu/ops/kernels.py:1174",
        madds=12, bytes=3 * LIMBS),
    "scalar_mul": dict(
        source="rofl_tpu_torch/csrc/scalar_mul.cu", replaces="rofl_tpu/ops/kernels.py:475",
        madds=least_ladder_madds(), bytes=9 * LIMBS),
    # The MSMs' bound is computed per shape by msm_bound_ms: 320 bytes a term
    # (a point and a 64-byte scalar), Pippenger's additions at its best window.
    "msm_flat": dict(
        source="rofl_tpu_torch/csrc/msm.cu", replaces="rofl_tpu/ops/kernels.py:763",
        madds=None, bytes=LIMBS * 4 + 64),
    "msm_groups": dict(
        source="rofl_tpu_torch/csrc/msm.cu", replaces="rofl_tpu/ops/kernels.py:763",
        madds=None, bytes=LIMBS * 4 + 64),
    "shared_scalar_mul": dict(
        source="rofl_tpu_torch/csrc/shared_scalar_mul.cu",
        replaces="rofl_tpu/ops/kernels.py:897", madds=None, bytes=8 * LIMBS),
    "scalar_mul_window": dict(
        source="rofl_tpu_torch/csrc/scalar_mul_window.cu",
        replaces="rofl_tpu/ops/kernels.py:493",
        madds=least_ladder_madds(), bytes=9 * LIMBS),
    # The sums' bound is computed per layout by sum_bound: a term read once
    # and a sum written once (a point, a scalar), against R - 1 additions
    # an output lane (a point addition; 8 word additions for scalars).
    "point_sum": dict(
        source="rofl_tpu_torch/csrc/point_sum.cu", replaces="rofl_tpu/ops/kernels.py:573",
        replaces_also="rofl_tpu/ops/kernels.py:615", madds=POINT_ADD_MADDS, bytes=4 * LIMBS),
    "sc_sum": dict(
        source="rofl_tpu_torch/csrc/sc_sum.cu", replaces="rofl_tpu/ops/kernels.py:1212",
        replaces_also="rofl_tpu/ops/kernels.py:627", madds=8, bytes=LIMBS),
}
NEW_KERNELS = ("sc_mul", "sc_add", "sc_sub", "scalar_mul")
# Lane counts the round gives the kernels (fixed-base tables: 1 and 8192;
# blindings, commits and wire: 50000; first halving of the 4-client sum:
# 100000; default BSGS table: 65537; small extract: 4096), and 77. The Σ path
# gives the scalar kernels 50000 lanes, and the first halving of the blinding
# sum 100000. Its ladders run at 50000 lanes (provers) and, one launch a
# verifier, at 100000, 150000 and 200000 lanes.
REJECT_LANES = 64
CHECK_LANES = (1, 77, SMALL_LANES, 8192, D, (1 << 16) + 1, 2 * D)
SCALAR_MUL_LANES = (1, 77, SMALL_LANES, D, 2 * D, 3 * D, 4 * D)


class PhaseClock:
    """Seconds between phase lines: each line of a phase carries the time
    since the line before it (the first since ``start``), so the phases'
    seconds add up to the script's."""

    def __init__(self):
        self.start()

    def start(self) -> None:
        self.mark = time.perf_counter()
        self.seconds: dict[str, float] = {}

    def lap(self, phase: str) -> float:
        now = time.perf_counter()
        self.seconds[phase] = now - self.mark
        self.mark = now
        return self.seconds[phase]


PHASES = PhaseClock()


def emit(obj: dict) -> None:
    if "phase" in obj:
        obj = {**obj, "phase_s": PHASES.lap(obj["phase"])}
    print(json.dumps(obj), flush=True)


def synced(fn):
    """(result, seconds) of fn() with the device drained before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def device_ms(fn, reps: int = 20, rounds: int = 5) -> float:
    """Median device time of one fn() in ms. The stream is first held busy so
    that the launches queue up behind it and run back to back: the events
    then bracket device time, not the host's time to enqueue."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(50_000_000)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return statistics.median(times)


def msm_bound_ms(n: int, group: int) -> tuple[float, str]:
    """Least time for n terms in groups of `group`: the bytes (each term read
    once) over the memory rate, or Pippenger's point additions at its best
    window c, ceil(257 / c) * (group + 2^c) a group with signed digits
    (2^(c-1) buckets; fewer than unsigned digits' ceil(256 / c) *
    (group + 2^(c+1))), at the 1152 multiply-adds of an addition, over the
    int32 rate."""
    adds = min(min(math.ceil(257 / c) * (group + 2 ** c),
                   math.ceil(256 / c) * (group + 2 ** (c + 1))) for c in range(1, 25))
    t_bytes = n * KERNEL_FACTS["msm_flat"]["bytes"] / HBM_BYTES_PER_S
    t_ops = (n // group) * adds * POINT_ADD_MADDS * 2 / INT32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def chain_madds(ops: str) -> int:
    """Multiply-adds of a run of doublings (D) and additions (A) in order: a
    doubling that another doubling follows leaves T out."""
    total = 0
    for i, op in enumerate(ops):
        if op == "A":
            total += POINT_ADD_MADDS
        elif ops[i + 1:i + 2] == "D":
            total += POINT_DOUBLE_NO_T_MADDS
        else:
            total += POINT_DOUBLE_MADDS
    return total


def least_shared_madds(k: int) -> int:
    """Multiply-adds of the cheapest common schedule for k * P with k known:
    the fewer of a fixed c-bit window (table of 2^c multiples: 2^(c-1) - 1
    doublings and as many adds; c doublings a window; an add a nonzero digit
    below the top one) and a width-w NAF (odd multiples up to 2^(w-1) - 1:
    one doubling and 2^(w-2) - 1 adds; a doubling a digit; an add a nonzero
    digit below the top one; negation is free), for the k given, each run
    of doublings counted by chain_madds. k = 0 and k = 1 need no
    arithmetic."""
    if k < 2:
        return 0
    costs = []
    for c in range(1, 9):
        digits = [(k >> s) & ((1 << c) - 1) for s in range(0, k.bit_length(), c)]
        table = ((1 << (c - 1)) - 1) * (POINT_DOUBLE_MADDS + POINT_ADD_MADDS)
        ops = "".join("D" * c + ("A" if x else "") for x in reversed(digits[:-1]))
        costs.append(table + chain_madds(ops))
    for w in range(2, 9):
        naf, x = [], k
        while x:
            digit = 0
            if x & 1:
                digit = x & ((1 << w) - 1)
                digit -= (1 << w) if digit >= 1 << (w - 1) else 0
                x -= digit
            naf.append(digit)
            x >>= 1
        table = POINT_DOUBLE_MADDS + ((1 << (w - 2)) - 1) * POINT_ADD_MADDS if w > 2 else 0
        ops = "".join("D" + ("A" if x else "") for x in reversed(naf[:-1]))
        costs.append(table + chain_madds(ops))
    return min(costs)


def shared_bound_ms(n: int, k: int) -> tuple[float, str]:
    """Least time for k * P_i on n lanes with one known k: the cheapest
    schedule's multiply-adds a lane (least_shared_madds) over the int32 rate,
    or the bytes, whichever is larger."""
    t_bytes = n * KERNEL_FACTS["shared_scalar_mul"]["bytes"] / HBM_BYTES_PER_S
    t_ops = n * least_shared_madds(k) * 2 / INT32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def sum_bound(name: str, outer: int, r: int, inner: int) -> dict:
    """Least time of a sum over (outer, r, inner): the bytes (each term read
    once, each sum written once) over the memory rate, or r - 1 additions an
    output lane over the int32 rate; both, and the larger as the bound."""
    f, m = KERNEL_FACTS[name], outer * inner
    t_bytes = (outer * r * inner + m) * f["bytes"] / HBM_BYTES_PER_S
    t_ops = max(r - 1, 0) * m * f["madds"] * 2 / INT32_OPS_PER_S
    return {"bound_ms": 1e3 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bound_bytes_ms": 1e3 * t_bytes, "bound_ops_ms": 1e3 * t_ops}


def bound_ms(name: str, n: int, madds: float | None = None) -> tuple[float, str]:
    """Least time the card could take for n lanes: every input read once and
    every output written once over the memory rate, or the multiply-adds
    (a lane's, KERNEL_FACTS' unless given) over the int32 rate, whichever is
    larger."""
    f = KERNEL_FACTS[name]
    t_bytes = n * f["bytes"] / HBM_BYTES_PER_S
    t_ops = n * (f["madds"] if madds is None else madds) * 2 / INT32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# -- phase 1: device -----------------------------------------------------------


def phase_device() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip().splitlines()[0]
    # The FL runtime speaks gRPC (fl/transport.py imports grpc), and the port
    # has no other transport: without grpc the run fails, here if not at this
    # script's imports. The JAX package's runtime needs the other two too;
    # the port needs neither.
    found = {name: importlib.util.find_spec(name) is not None
             for name in ("grpc", "google.protobuf", "yaml")}
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0], "importable": found,
          "transport": "grpc",
          "grpcio": importlib.metadata.version("grpcio") if found["grpc"] else None})
    if not found["grpc"]:
        sys.exit("device failed: grpc does not import, and the FL runtime's transport needs it")
    return smi


# -- phase 2: build ------------------------------------------------------------


def phase_build() -> dict:
    t0 = time.perf_counter()
    kernels.build_kernels()
    seconds = time.perf_counter() - t0
    version = subprocess.run([kernels.nvcc_path(), "--version"], check=True,
                             capture_output=True, text=True).stdout
    version = next(ln.strip() for ln in version.splitlines() if "release" in ln)
    ptxas = {}
    for name, log in kernels.BUILD_LOGS.items():
        entries = []
        # one chunk per kernel entry point, a list for every source
        # (scalar_mul_window.cu has one entry for W = 2 and one for W = 4)
        for chunk in log.split("Compiling entry function")[1:]:
            entry = re.search(r"'(\S+)'", chunk)
            used = re.search(r"Used (\d+) registers", chunk)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", chunk)
            smem = re.search(r"(\d+) bytes smem", chunk)
            entries.append({"entry": entry.group(1), "registers": int(used.group(1)),
                            "spill_store_bytes": int(spill.group(1)),
                            "spill_load_bytes": int(spill.group(2)),
                            "shared_bytes": int(smem.group(1)) if smem else 0})
        ptxas[name] = entries
    emit({"phase": "build", "seconds": seconds, "nvcc": version, "ptxas": ptxas})
    return ptxas


# -- phase 3: kernels against their plain versions -----------------------------


def test_points(n: int, rng: np.random.Generator):
    """Two (x, y, z, t) tuples of n lanes on the card: random group elements
    in random projective representations, with identity, basepoint and
    P, -P pairs among them."""
    pool = [SR.hash_from_bytes_sha512(rng.bytes(16)) for _ in range(12)]
    pool += [SR.identity(), SR.BASEPOINT, -SR.BASEPOINT, pool[0], -pool[0]]
    packed = curve.pack_points(pool, DEVICE)
    i = torch.from_numpy(rng.integers(0, len(pool), size=n)).to(DEVICE)
    j = torch.from_numpy(rng.integers(0, len(pool), size=n)).to(DEVICE)
    if n >= len(pool):  # every pool member at least once, P + P and P + (-P) included
        i[:len(pool)] = torch.arange(len(pool))
        j[:len(pool)] = torch.tensor(
            list(range(12)) + [12, 14, 13, 16, 15], device=DEVICE)
    scale = fe.to_tensor(rng.integers(1, 1 << 16, size=(16, n)), DEVICE)
    p = tuple(fe.mul(c[:, i], scale) for c in packed)
    q = tuple(c[:, j].contiguous() for c in packed)
    return p, q


def compress_rotated_share(p) -> float:
    """Share of the lanes of p whose encoding rotates (the spec's select on
    each representative): only those need the products by sqrt(-1) and by
    1/sqrt(a - d)."""
    points = curve.unpack_points(curve.PointArray(*(c.cpu() for c in p)))
    return sum(q.encode_selects()[0] for q in points) / len(points)


def test_encodings(enc: torch.Tensor, rng: np.random.Generator) -> torch.Tensor:
    """Valid encodings with invalid ones mixed in: random field elements
    below 2^255 (non-squares, negative t), odd s, random s with bit 255 set,
    s in [p, 2^255), and s = 0 and 1."""
    n = enc.shape[1]
    s = enc.clone()
    rand = fe.to_tensor(rng.integers(0, 1 << 16, size=(16, n)), DEVICE)
    high = rand.clone()
    rand[15] &= 0x7FFF
    high[15] |= 0x8000
    above_p = fe.to_tensor(fe.pack_scalars(range(SF.P, 2**255)), DEVICE)
    above_p = above_p[:, torch.from_numpy(rng.integers(0, 19, size=n)).to(DEVICE)]
    kind = torch.from_numpy(rng.integers(0, 6, size=n)).to(DEVICE)
    for k, v in ((1, rand), (4, high), (5, above_p)):
        s = torch.where((kind == k).unsqueeze(0), v, s)
    s[0] = torch.where(kind == 2, s[0] ^ 1, s[0])
    s[:, -1] = 0
    s[0, -1] = n % 2
    return s


def max_abs_err(got, want, field: bool = True) -> int:
    """Largest limb difference: between the canonical representatives mod p
    for field elements, between the limbs as they are for scalars and masks."""
    err = 0
    for a, b in zip(got, want):
        if field and a.dtype == fe.DTYPE:
            a, b = fe.canonicalize(a), fe.canonicalize(b.expand_as(a))
        err = max(err, int((a.to(torch.int32) - b.to(torch.int32)).abs().max()))
    return err


EDGE_SCALARS = (0, 1, SS.L - 1, 1 << 252)


def test_scalars(n: int, rng: np.random.Generator):
    """Two (16, n) batches of canonical scalars on the card: uniform, with
    every pairing of 0, 1, l-1 and 2^252 in the first 16 lanes."""
    a, b = (kernels.sc_reduce_wide(torch.from_numpy(
        rng.integers(0, 256, size=(64, n)).astype(np.int32)).to(DEVICE)) for _ in range(2))
    if n >= len(EDGE_SCALARS) ** 2:
        pairs = [(x, y) for x in EDGE_SCALARS for y in EDGE_SCALARS]
        a[:, :len(pairs)] = fe.to_tensor(sc.pack_scalars([x for x, _ in pairs]), DEVICE)
        b[:, :len(pairs)] = fe.to_tensor(sc.pack_scalars([y for _, y in pairs]), DEVICE)
    return a, b


def lowest_digits(c: int) -> int:
    """The scalar whose signed c-bit digits below the top one are all
    -2^(c-1) (every radix-16 digit -8 at c = 4): 2^256 less the recoding's
    offset (csrc/fe25519_32.cuh recode_offset)."""
    return 2**256 - sum((1 << (c - 1)) << (c * i) for i in range(-(-257 // c) - 1))


# Not reduced mod l: the ladder and the MSMs take all 256 bits of k.
EDGE_LADDER_SCALARS = (0, 1, SS.L - 1, 2**256 - 1, lowest_digits(4),
                       lowest_digits(kernels.MSM_WINDOW))


def test_ladder_operands(n: int, rng: np.random.Generator):
    """Scalars and points for scalar_mul and the MSMs: random ones, and
    EDGE_LADDER_SCALARS against a random point, the basepoint and the
    identity."""
    p, _ = test_points(n, rng)
    k, _ = test_scalars(n, rng)
    if n >= 32:
        edge_k = fe.to_tensor(fe.pack_scalars(EDGE_LADDER_SCALARS), DEVICE)
        e = len(EDGE_LADDER_SCALARS)
        fixed = {0: None, 17: curve.basepoint((1,), DEVICE),
                 17 + e: curve.identity((1,), DEVICE)}
        for first, point in fixed.items():
            k[:, first:first + e] = edge_k
            if point is not None:
                for c, v in zip(p, point):
                    c[:, first:first + e] = v
    return k, p


# The 2- and 4-torsion points: added to a point they give the four
# representatives of its Ristretto element, which between them take each side
# of the encoding's rotate and negate-y selects. In Ristretto each is the
# identity.
TORSION = (SR.identity(), SR.RistrettoPoint(0, SF.P - 1, 1, 0),
           SR.RistrettoPoint(SF.SQRT_M1, 0, 1, 0), SR.RistrettoPoint(-SF.SQRT_M1, 0, 1, 0))


def packed(coords) -> tuple:
    """Four lists of Python ints below 2^256 -> (x, y, z, t) on the card."""
    return tuple(fe.to_tensor(fe.pack_scalars(values), DEVICE) for values in coords)


def edge_inputs(rng: np.random.Generator) -> dict:
    """name -> ((x, y, z, t) on the card, the spec's encodings): each
    representative of random points and the basepoint in a random projective
    scale; the identity as (0 : s : s : 0), s = 2^256 - 1 (every limb
    2^16 - 1) among them, and as each torsion point; and points whose
    coordinates are raised by the largest multiple of p that keeps them
    below 2^256, as the 32-bit kernels may leave them."""
    pool = [SR.hash_from_bytes_sha512(rng.bytes(16)) for _ in range(8)] + [SR.BASEPOINT]
    reps = [a + t for a in pool for t in TORSION]
    scale = [int.from_bytes(rng.bytes(32), "little") % (SF.P - 1) + 1 for _ in reps]
    s = [1, 2**256 - 1, SF.P + 1, 2**255, int.from_bytes(rng.bytes(32), "little") % SF.P or 1]
    ident = [[0] * len(s), s, s, [0] * len(s)]
    weak = pool + [-SR.BASEPOINT]
    return {
        "representatives": (
            packed([[getattr(a, c) * k % SF.P for a, k in zip(reps, scale)] for c in "XYZT"]),
            [a.compress() for a in reps]),
        "identity_forms": (
            packed([v + [getattr(t, c) for t in TORSION] for v, c in zip(ident, "XYZT")]),
            [bytes(32)] * (len(s) + len(TORSION))),
        "weakly_reduced": (
            packed([[v + (2**256 - 1 - v) // SF.P * SF.P for v in (getattr(a, c) for a in weak)]
                    for c in "XYZT"]),
            [a.compress() for a in weak]),
    }, {a.encode_selects() for a in reps}


def check_compress_first(records: dict, hold, rng: np.random.Generator) -> None:
    """compress against its plain version, before any check reads a point
    through it (scalar_mul, the MSMs and tune_kernels compare encodings):
    on edge_inputs, alone and tiled to N = 1, 77 and 50000 lanes, and on what
    the 32-bit point_add (operands and a broadcast lane on either side),
    scalar_mul and msm_groups leave. point_add is held on the same edge
    inputs, and point_double on every input compress is held on. Ends the
    run at the first disagreement."""
    cases = {}

    def check(name, p, want=None):
        got, ref = kernels.compress(p), kernels.compress_ref(p)
        ok = max_abs_err((got,), (ref,)) == 0
        hold("compress", (got,), (ref,))
        if want is not None:
            ok &= [bytes(r) for r in fe.to_bytes_array(got.cpu())] == want
        doubled, doubled_ref = kernels.point_double(p), kernels.point_double_ref(p)
        double_ok = max_abs_err(doubled, doubled_ref) == 0
        hold("point_double", doubled, doubled_ref)
        cases[name] = {"lanes": got.shape[1], "match": bool(ok),
                       "point_double_match": bool(double_ok)}
        if not ok:
            records["compress"]["match"] = False

    edges, selects = edge_inputs(rng)
    for name, (p, want) in edges.items():
        check(name, p, want)
    every = tuple(torch.cat(c, dim=1) for c in zip(*(p for p, _ in edges.values())))
    every_want = [b for _, want in edges.values() for b in want]
    # (0 : s : s : 0) with s = 2^256 - 1: the identity, every limb 2^16 - 1
    one = tuple(c[:, 1:2].contiguous() for c in edges["identity_forms"][0])
    for n in (1, 77, D):
        idx = torch.arange(n, device=DEVICE) % every[0].shape[1]
        p = tuple(c[:, idx].contiguous() for c in every)
        check(f"edges_at_{n}", p, [every_want[i] for i in idx.tolist()] if n < D else None)
        q = tuple(c.roll(1, dims=1).contiguous() for c in p)
        for a, b in ((p, q), (p, one), (one, p)):
            out = kernels.point_add(a, b)
            hold("point_add", out, kernels.point_add_ref(a, b))
            check(f"point_add_of_edges_at_{n}" + ("" if b is q else "_broadcast"), out)
    p, q = test_points(D, rng)  # P + (-P) among the pairs
    q1 = tuple(c[:, :1].contiguous() for c in q)
    check("point_add_outputs", kernels.point_add(p, q))
    check("point_add_outputs_broadcast", kernels.point_add(q1, p))
    for n in (77, D):
        k, p = test_ladder_operands(n, rng)
        check(f"scalar_mul_outputs_at_{n}", kernels.scalar_mul(k, p))
    k, p = test_ladder_operands(MSM_N_GROUPS * 64, rng)
    check("msm_groups_outputs", kernels.msm_groups(k, p, 64))
    torch.cuda.synchronize()
    covered = sorted([bool(r), bool(g)] for r, g in selects)
    emit({"phase": "compress_first", "selects_covered": covered, "cases": cases})
    records["compress"]["first_checks"] = {name: c["lanes"] for name, c in cases.items()}
    if len(covered) < 4 or not all(c["match"] for c in cases.values()):
        sys.exit("compress disagrees with its plain version or the spec, or the edge inputs "
                 "missed a side of its selects: no later check may lean on it")
    if not all(c["point_double_match"] for c in cases.values()):
        sys.exit("point_double disagrees with its plain version on the edge inputs")


def check_decompress_edges(hold, rng: np.random.Generator) -> None:
    """decompress against its plain version (mask and canonical coordinates)
    and the mask against the spec's decoding of s mod p (the raw bytes'
    check s < p is the caller's), z as canonical 1: on each of the host
    tests' edge cases (tests/torch_port_edges.py: s = 0, 1, p - 1; every s
    in [p, 2^255); s with bit 255 set; odd s; non-squares; the encodings
    whose y is 0; valid encodings), and on all of them tiled to N = 1, 77
    and 50000 lanes. Ends the run at the first disagreement."""
    cases = {}

    def check(name, values, want):
        s = fe.to_tensor(fe.pack_scalars(values), DEVICE)
        (k_pt, k_valid), (r_pt, r_valid) = kernels.decompress(s), kernels.decompress_ref(s)
        hold("decompress", k_pt + (k_valid,), r_pt + (r_valid,))
        ok = (max_abs_err(k_pt + (k_valid,), r_pt + (r_valid,)) == 0
              and k_valid.cpu().tolist() == want
              and bool(torch.equal(k_pt[2], fe.ones((len(values),), DEVICE))))
        cases[name] = {"lanes": len(values), "valid": int(k_valid.sum()), "match": bool(ok)}

    by_case = {case: decompress_edges(case, rng) for case in DECOMPRESS_EDGE_CASES}
    verdicts = {v: spec_decompress(v) is not None
                for values in by_case.values() for v in values}
    for name, values in by_case.items():
        check(name, values, [verdicts[v] for v in values])
    every = [v for values in by_case.values() for v in values]
    for n in (1, 77, D):
        tiled = [every[i % len(every)] for i in range(n)]
        check(f"edges_at_{n}", tiled, [verdicts[v] for v in tiled])
    torch.cuda.synchronize()
    emit({"phase": "decompress_edges", "cases": cases})
    if not all(c["match"] for c in cases.values()):
        sys.exit("decompress disagrees with its plain version or the spec on the edge inputs")


SC_KERNELS = {
    "sc_mul": (kernels.sc_mul, kernels.sc_mul_ref),
    "sc_add": (kernels.sc_add, kernels.sc_add_ref),
    "sc_sub": (kernels.sc_sub, kernels.sc_sub_ref),
}


def phase_kernels() -> dict:
    rng = np.random.default_rng(SEED)
    records = {name: {"name": name, "route": "cuda", "match": True, "max_abs_err": 0,
                      "checked_lanes": list(CHECK_LANES)} for name in KERNEL_FACTS}
    records["scalar_mul"]["checked_lanes"] = list(SCALAR_MUL_LANES)

    def hold(name, got, want, field=True):
        err = max_abs_err(got, want, field)
        records[name]["max_abs_err"] = max(records[name]["max_abs_err"], err)
        if err != 0:
            records[name]["match"] = False

    def timed(name, n, kernel_fn, plain_fn=None, plain_ms=None, madds=None, **kwargs):
        records[name]["n"] = n
        records[name]["ms"] = device_ms(kernel_fn, **kwargs)
        records[name]["plain_ms"] = plain_ms if plain_fn is None else (
            1e3 * min(synced(plain_fn)[1] for _ in range(2)))
        records[name]["bound_ms"], records[name]["bound_by"] = bound_ms(name, n, madds)
        records[name]["library_ms"] = None

    check_compress_first(records, hold, rng)
    check_decompress_edges(hold, rng)

    for n in CHECK_LANES:
        p, q = test_points(n, rng)
        q1 = tuple(c[:, :1].contiguous() for c in q)
        hold("point_add", kernels.point_add(p, q), kernels.point_add_ref(p, q))
        hold("point_add", kernels.point_add(p, q1), kernels.point_add_ref(p, q1))
        hold("point_add", kernels.point_add(q1, p), kernels.point_add_ref(q1, p))
        hold("point_double", kernels.point_double(p), kernels.point_double_ref(p))
        enc = kernels.compress(p)
        hold("compress", (enc,), (kernels.compress_ref(p),))
        s = test_encodings(enc, rng)
        (k_pt, k_valid), (r_pt, r_valid) = kernels.decompress(s), kernels.decompress_ref(s)
        hold("decompress", k_pt + (k_valid,), r_pt + (r_valid,))
        wide = torch.from_numpy(rng.integers(0, 256, size=(64, n)).astype(np.int32)).to(DEVICE)
        wide[:, 0] = 255  # 2^512 - 1
        wide[:, -1] = 0
        hold("sc_reduce_wide", (kernels.sc_reduce_wide(wide),),
             (kernels.sc_reduce_wide_ref(wide),), field=False)
        a, b = test_scalars(n, rng)
        b1 = b[:, n // 2:n // 2 + 1].contiguous()
        for name, (kernel_fn, plain_fn) in SC_KERNELS.items():
            for x, y in ((a, b), (a, b1), (b1, a)):
                hold(name, (kernel_fn(x, y),), (plain_fn(x, y),), field=False)
        if n == D:
            calls = {
                "point_add": (lambda: kernels.point_add(p, q), lambda: kernels.point_add_ref(p, q)),
                "point_double": (lambda: kernels.point_double(p),
                                 lambda: kernels.point_double_ref(p)),
                "compress": (lambda: kernels.compress(p), lambda: kernels.compress_ref(p)),
                "decompress": (lambda: kernels.decompress(enc),
                               lambda: kernels.decompress_ref(enc)),
                "sc_reduce_wide": (lambda: kernels.sc_reduce_wide(wide),
                                   lambda: kernels.sc_reduce_wide_ref(wide)),
            }
            calls.update({name: (lambda f=fns[0]: f(a, b), lambda f=fns[1]: f(a, b))
                          for name, fns in SC_KERNELS.items()})
            rotated = compress_rotated_share(p)
            madds = {"compress": KERNEL_FACTS["compress"]["madds"] + 3 * MUL * rotated}
            for name, (kernel_fn, plain_fn) in calls.items():
                timed(name, n, kernel_fn, plain_fn, madds=madds.get(name))
            records["compress"]["rotated_share"] = rotated
            records["decompress"]["valid_share"] = float(k_valid.float().mean())

    # scalar_mul: the kernel walks the bits from the top, the plain version
    # from the bottom, so the results are held equal as canonical encodings.
    # Above 50000 lanes the operands are the first lanes of msm_flat's, whose
    # plain ladders are computed once (ladder_terms).
    flat = ladder_terms(MSM_PATH_SHAPES["msm_flat"][0], rng)
    for n in SCALAR_MUL_LANES:
        if n > D:
            k, p, want = lanes(flat["k"], n), lanes(flat["p"], n), lanes(flat["terms"], n)
        else:
            k, p = test_ladder_operands(n, rng)
            want, plain_seconds = synced(lambda: kernels.scalar_mul_ref(k, p))
        got = kernels.scalar_mul(k, p)
        hold("scalar_mul", (kernels.compress(got),), (kernels.compress(want),))
        if n <= D:  # one scalar for every point: a random one, and the all -8 one
            for b in (n // 2, 4) if n >= 32 else (n // 2,):
                k1 = k[:, b:b + 1].contiguous()
                hold("scalar_mul", (kernels.compress(kernels.scalar_mul(k1, p)),),
                     (kernels.compress(kernels.scalar_mul_ref(k1, p)),))
        if n == D:
            timed("scalar_mul", n, lambda: kernels.scalar_mul(k, p),
                  plain_ms=1e3 * plain_seconds, reps=3, rounds=3)
        if n == 4 * D:
            records["scalar_mul"]["ms_at_4n"] = device_ms(
                lambda: kernels.scalar_mul(k, p), reps=2, rounds=3)
    check_msm(records, hold, rng, flat)
    del flat
    check_shared_and_window(records, hold, rng)
    check_sums(records, hold, rng)
    torch.cuda.synchronize()
    bad = [name for name, r in records.items() if not r["match"]]
    emit({"phase": "kernels", "tolerance": "canonical limbs and masks bit-equal (0)",
          "kernels": list(records.values())})
    if bad:
        sys.exit(f"kernels disagree with their plain versions: {bad}")
    return records


# The MSMs against their plain version (a ladder per lane, then the halving
# sums): flat at N = 1 and 77, in 16 groups of 2, 64 and 4096; the first
# lanes hold EDGE_LADDER_SCALARS on a random point, the basepoint and the
# identity; one broadcast scalar at 77 lanes and, the all -8 one, at 16
# groups of 64. Then held equal and timed, kernel and plain version on the
# same inputs, at the l2 path's shapes, where the kernel cuts each group
# into slices: the provers' S sum (16 groups of 65536 terms), the batched
# square-rand verify (300 000 terms) and the range proofs' combined verify
# (131 618 terms). msm_flat's two shapes share one set of operands: the
# plain version at 300 000 terms is the sum of the plain ladders, which are
# made once (ladder_terms), and at 131 618 the sum of their first lanes.
MSM_FLAT_LANES = (1, 77)
MSM_GROUPS = (2, 64, 4096)
MSM_N_GROUPS = 16
MSM_PATH_SHAPES = {"msm_groups": (16 << 16, 1 << 16), "msm_flat": (300_000, 300_000)}
MSM_VERIFY_TERMS = 131_618


def msm_plan(n_groups: int, group: int) -> int:
    """The slices a group the MSM wrapper picks on this card."""
    return kernels.msm_slices(n_groups, group, kernels.MSM_DIGITS,
                              kernels.msm_blocks_per_wave(torch.device(DEVICE)))


def lanes(x, n: int):
    """The first n lanes of a (16, N) tensor or of a tuple of them, contiguous."""
    if isinstance(x, torch.Tensor):
        return x[:, :n].contiguous()
    return tuple(c[:, :n].contiguous() for c in x)


def ladder_terms(n: int, rng: np.random.Generator) -> dict:
    """Ladder operands of n lanes and their plain ladders, k_i * P_i, as
    ``kernels.msm_groups_ref`` computes them (``scalar_mul_ref`` in slices
    of ``MSM_REF_SLICE`` lanes), once for the checks that need their first
    lanes; with the seconds that took."""
    k, p = test_ladder_operands(n, rng)
    step = kernels.MSM_REF_SLICE

    def plain():
        parts = [kernels.scalar_mul_ref(k[:, lo:lo + step], tuple(c[:, lo:lo + step] for c in p))
                 for lo in range(0, n, step)]
        return tuple(torch.cat(cs, dim=1) for cs in zip(*parts))

    terms, seconds = synced(plain)
    return {"k": k, "p": p, "terms": terms, "seconds": seconds}


def check_msm(records: dict, hold, rng: np.random.Generator, flat: dict) -> None:
    def encodings(out):
        return (kernels.compress(tuple(out)),)

    def call(name, k, p, group):
        if name == "msm_flat":
            return kernels.msm_flat(k, p), (lambda: kernels.msm_flat_ref(k, p))
        return kernels.msm_groups(k, p, group), (lambda: kernels.msm_groups_ref(k, p, group))

    for name in ("msm_flat", "msm_groups"):
        records[name]["checked_lanes"] = []
    for n in MSM_FLAT_LANES:
        k, p = test_ladder_operands(n, rng)
        hold("msm_flat", encodings(kernels.msm_flat(k, p)), encodings(kernels.msm_flat_ref(k, p)))
        records["msm_flat"]["checked_lanes"].append(n)
        if n > 1:
            k1 = k[:, n // 2:n // 2 + 1].contiguous()
            hold("msm_flat", encodings(kernels.msm_flat(k1, p)),
                 encodings(kernels.msm_flat_ref(k1, p)))
    for group in MSM_GROUPS:
        n = group * MSM_N_GROUPS
        k, p = test_ladder_operands(n, rng)
        hold("msm_groups", encodings(kernels.msm_groups(k, p, group)),
             encodings(kernels.msm_groups_ref(k, p, group)))
        records["msm_groups"]["checked_lanes"].append([MSM_N_GROUPS, group])
        if group == 64:
            k1 = k[:, 4:5].contiguous()
            hold("msm_groups", encodings(kernels.msm_groups(k1, p, group)),
                 encodings(kernels.msm_groups_ref(k1, p, group)))

    for name, (n, group) in MSM_PATH_SHAPES.items():
        rec = records[name]
        if name == "msm_flat":  # msm_flat_ref: the sum of the plain ladders
            k, p = flat["k"], flat["p"]
            got = kernels.msm_flat(k, p)
            want, sum_seconds = synced(lambda: kernels.point_sum_ref(flat["terms"], 1, n, 1))
            plain_seconds = flat["seconds"] + sum_seconds
        else:
            k, p = test_ladder_operands(n, rng)
            got, plain = call(name, k, p, group)
            want, plain_seconds = synced(plain)
        hold(name, encodings(got), encodings(want))
        rec["checked_lanes"].append(n if name == "msm_flat" else [n // group, group])
        rec["n"], rec["group"] = n, group
        rec["window"] = kernels.MSM_WINDOW
        rec["slices"] = msm_plan(n // group, group)
        rec["ms"] = device_ms(lambda: call(name, k, p, group)[0], reps=2, rounds=3)
        rec["plain_ms"] = 1e3 * plain_seconds
        rec["bound_ms"], rec["bound_by"] = msm_bound_ms(n, group)
        rec["library_ms"] = None
        if name == "msm_flat":
            kv, pv = lanes(k, MSM_VERIFY_TERMS), lanes(p, MSM_VERIFY_TERMS)
            want = kernels.point_sum_ref(lanes(flat["terms"], MSM_VERIFY_TERMS), 1,
                                         MSM_VERIFY_TERMS, 1)
            hold(name, encodings(kernels.msm_flat(kv, pv)), encodings(want))
            rec["checked_lanes"].append(MSM_VERIFY_TERMS)
            rec["slices_at_131618"] = msm_plan(1, MSM_VERIFY_TERMS)
            rec["ms_at_131618"] = device_ms(lambda: kernels.msm_flat(kv, pv), reps=2, rounds=3)
            rec["bound_ms_at_131618"] = msm_bound_ms(MSM_VERIFY_TERMS, MSM_VERIFY_TERMS)[0]
        del k, p, got, want
        torch.cuda.empty_cache()


# shared_scalar_mul: one scalar for all N = 50000 lanes of test_points (the
# identity and the basepoint among them); each scalar below is held equal to
# the plain version and timed, the kernel's time following the number of
# nonzero digits of its width-5 NAF (2^256 - 1: digits 0 and 256 only).
# The scalar goes to the wrapper as a tensor on the card for the check and as
# host limbs for the timing (the wrapper copies it to the host either way; a
# copy from the card would stall the queued launches).
SHARED_SCALARS = {"random": None, "zero": 0, "one": 1, "two": 2, "l_minus_1": SS.L - 1,
                  "low_weight": (1 << 200) | 5, "high_weight": 2**253 - 1,
                  "all_ones": 2**256 - 1}
WINDOW_BROADCAST_LANES = 77


def check_shared_and_window(records: dict, hold, rng: np.random.Generator) -> None:
    def encodings(out):
        return (kernels.compress(tuple(out)),)

    rec = records["shared_scalar_mul"]
    rec["checked_lanes"], rec["scalars"] = [D], []
    p, _ = test_points(D, rng)
    for name, k in SHARED_SCALARS.items():
        if k is None:
            k = int.from_bytes(rng.bytes(32), "little") % SS.L
        limbs = fe.to_tensor(sc.pack_scalars([k]), DEVICE)
        got = kernels.shared_scalar_mul(limbs, p)
        want, plain_seconds = synced(lambda: kernels.shared_scalar_mul_ref(limbs, p))
        hold("shared_scalar_mul", encodings(got), encodings(want))
        host_limbs = sc.pack_scalars([k])
        ms = device_ms(lambda: kernels.shared_scalar_mul(host_limbs, p), reps=3, rounds=3)
        bound, by = shared_bound_ms(D, k)
        rec["scalars"].append({"name": name, "hamming_weight": bin(k).count("1"),
                               "naf_nonzero": int(np.count_nonzero(kernels.naf_digits(k))),
                               "ms": ms, "plain_ms": 1e3 * plain_seconds, "bound_ms": bound,
                               "bound_by": by})
        if name == "random":
            rec.update(n=D, ms=ms, plain_ms=1e3 * plain_seconds, bound_ms=bound, bound_by=by,
                       library_ms=None)
    try:
        kernels.shared_scalar_mul(fe.to_tensor(sc.pack_scalars([1, 2]), DEVICE), p)
        rec["two_scalars_refused"] = False
        rec["match"] = False
    except ValueError:
        rec["two_scalars_refused"] = True
    del p

    rec = records["scalar_mul_window"]
    rec["checked_lanes"], rec["windows"] = [D, WINDOW_BROADCAST_LANES], {}
    k, p = test_ladder_operands(D, rng)
    ladder = encodings(kernels.scalar_mul(k, p))
    kb, pb = test_ladder_operands(WINDOW_BROADCAST_LANES, rng)
    kb = kb[:, 5:6].contiguous()
    for w in kernels.WINDOWS:
        got = kernels.scalar_mul_window(k, p, w)
        want, plain_seconds = synced(lambda: kernels.scalar_mul_window_ref(k, p, w))
        hold("scalar_mul_window", encodings(got), encodings(want))
        hold("scalar_mul_window", encodings(got), ladder)  # scalar_mul's function
        hold("scalar_mul_window", encodings(kernels.scalar_mul_window(kb, pb, w)),
             encodings(kernels.scalar_mul_window_ref(kb, pb, w)))
        ms = device_ms(lambda: kernels.scalar_mul_window(k, p, w), reps=3, rounds=3)
        rec["windows"][w] = {"ms": ms, "plain_ms": 1e3 * plain_seconds,
                             "bound_ms": bound_ms("scalar_mul_window", D)[0]}
    rec.update(n=D, ms=rec["windows"][4]["ms"], plain_ms=rec["windows"][4]["plain_ms"],
               library_ms=None, scalar_mul_ms_same_inputs=device_ms(
                   lambda: kernels.scalar_mul(k, p), reps=3, rounds=3))
    rec["bound_ms"], rec["bound_by"] = bound_ms("scalar_mul_window", D)
    refused = []
    for w in (1, 3, 8):
        try:
            kernels.scalar_mul_window(k, p, w)
        except ValueError:
            refused.append(w)
    rec["other_windows_refused"] = refused == [1, 3, 8]
    rec["match"] &= rec["other_windows_refused"]
    del k, p
    torch.cuda.empty_cache()


# The sums against their plain versions (halving chains of the plain adds)
# at the paths' layouts (outer, R, inner): tree_sum of d (EncL2's verify), the
# provers' A sums (16 chunks of 32768), the IPA's groups (32 of h, h = 16384
# .. 1), the clients' commitment and blinding sums, the range verifier's
# chunk-axis sums, and a ragged length; sc_sum also on 100001 terms of l - 1.
# Each timed beside its plain version and beside the chain it replaced:
# the same halving loop run on point_add / sc_add launches
# (kernels.halving_sums), which no path runs any more.
SUM_LAYOUTS = ((1, D, 1), (16, 32768, 1), (32, 1, 1), (32, 2, 1), (32, 3, 1), (32, 77, 1),
               (32, 16384, 1), (1, N_CLIENTS, D), (1, 16, 32768), (1, 100001, 1))


def check_sums(records: dict, hold, rng: np.random.Generator) -> None:
    waves = kernels.sum_blocks_per_wave(torch.device(DEVICE))
    for name in ("point_sum", "sc_sum"):
        records[name].update(checked_lanes=[list(x) for x in SUM_LAYOUTS], layouts=[],
                             library_ms=None)
    for layout in SUM_LAYOUTS:
        n = layout[0] * layout[1] * layout[2]
        p, _ = test_points(n, rng)
        a, _ = test_scalars(n, rng)
        cases = {
            "point_sum": (lambda: kernels.point_sum(p, *layout),
                          lambda: kernels.point_sum_ref(p, *layout),
                          lambda: kernels.halving_sums(p, *layout, kernels.point_add,
                                                       kernels.IDENTITY_PAD)),
            "sc_sum": (lambda: kernels.sc_sum(a, *layout),
                       lambda: kernels.sc_sum_ref(a, *layout),
                       lambda: kernels.halving_sums(
                           (a,), *layout, lambda x, y: (kernels.sc_add(x[0], y[0]),),
                           (fe.zeros,))),
        }
        for name, (kernel_fn, plain_fn, chain_fn) in cases.items():
            got = kernel_fn()
            want, plain_seconds = synced(plain_fn)
            if name == "point_sum":  # another order of additions: compare encodings
                got, want = (kernels.compress(got),), (kernels.compress(want),)
            else:
                got, want = (got,), (want,)
            match = max_abs_err(got, want, field=False) == 0
            hold(name, got, want, field=False)
            row = {"layout": list(layout), "plan": list(kernels.sum_plan(*layout, waves)),
                   "match": match, "ms": device_ms(kernel_fn, reps=5, rounds=3),
                   "chain_ms": device_ms(chain_fn, reps=3, rounds=3),
                   "plain_ms": 1e3 * plain_seconds, **sum_bound(name, *layout)}
            records[name]["layouts"].append(row)
            if layout == (1, D, 1):
                records[name].update(n=D, ms=row["ms"], chain_ms=row["chain_ms"],
                                     plain_ms=row["plain_ms"], bound_ms=row["bound_ms"],
                                     bound_by=row["bound_by"],
                                     bound_bytes_ms=row["bound_bytes_ms"],
                                     bound_ops_ms=row["bound_ops_ms"])
        del p, a
        torch.cuda.empty_cache()
    top = fe.to_tensor(sc.pack_scalars([SS.L - 1]), DEVICE).expand(16, 100001).contiguous()
    got = kernels.sc_sum(top, 1, 100001, 1)
    hold("sc_sum", (got,), (kernels.sc_sum_ref(top, 1, 100001, 1),), field=False)
    equal = sc.unpack_scalars(got) == [(SS.L - 1) * 100001 % SS.L]
    records["sc_sum"]["l_minus_1_100001_equal"] = equal
    records["sc_sum"]["match"] &= equal


# -- phase 4: the round ----------------------------------------------------------


ROUND_KERNELS = ("point_add", "point_double", "compress", "decompress", "sc_reduce_wide",
                 "sc_sub", "point_sum", "sc_sum")
SIGMA_KERNELS = ("point_add", "compress", "decompress", "sc_reduce_wide") + NEW_KERNELS


def start_path() -> None:
    """Zero every launch and lane count and the peak-memory mark before a path
    is driven."""
    for name in kernels.LAUNCHES:
        kernels.LAUNCHES[name] = 0
        kernels.LANES[name] = 0
    torch.cuda.reset_peak_memory_stats()


def path_counts() -> dict:
    """Launches and lanes launched by kernel since start_path."""
    return {"launches": dict(kernels.LAUNCHES), "lanes": dict(kernels.LANES)}


def restore_counts(saved: dict) -> None:
    """Put back the counts of path_counts(): what ran since was a check or a
    measurement beside the path, not the path."""
    kernels.LAUNCHES.update(saved["launches"])
    kernels.LANES.update(saved["lanes"])


def phase_round() -> tuple[dict, dict]:
    rng = np.random.default_rng(SEED + 1)
    seconds = {}

    def stage(name, fn):
        out, seconds[name] = synced(fn)
        return out

    # A fresh process state: no fixed-base or BSGS table is built yet.
    pedersen.base_B.cache_clear()
    pedersen.base_H.cache_clear()
    bsgs.clear_tables()
    start_path()

    bits = rng.integers(-UPDATE_BITS, UPDATE_BITS + 1, size=(N_CLIENTS, D))
    updates = (bits / FP.scale).astype(np.float32)
    want = (bits.sum(axis=0) / FP.scale).astype(np.float32)

    # Pedersen-blob form, through the bindings. The cancelling vector is summed
    # and negated on the card: sc_sum and sc_sub launches.
    blindings = stage("generate_cancelling_blindings",
                      lambda: bindings.generate_cancelling_blindings(
                          N_CLIENTS, D, rng, device=DEVICE))
    blinding_launches = {k: kernels.LAUNCHES[k] for k in ("sc_reduce_wide", "sc_sum", "sc_sub")}
    blinding_sum = bindings.add_scalars(
        sv.serialize_scalar_vec(np.concatenate(
            [sv.deserialize_scalar_vec(b)[:, :REJECT_LANES] for b in blindings], axis=1)),
        device=DEVICE)
    blindings_cancel = blinding_sum == sv.serialize_scalar(0)
    # What the stage is made of, each timed apart on the same data: one draw of
    # D scalars (XOF in plain torch + sc_reduce_wide), the sum and negation of
    # N_CLIENTS - 1 vectors on the card (sc_sum, sc_sub), the framing of one
    # blob on the host, and the same sum as Python integers on the host, which
    # the sum on the card replaced.
    saved = path_counts()
    vecs = [fe.to_tensor(sv.deserialize_scalar_vec(b), DEVICE) for b in blindings[:-1]]
    stage("blindings_one_draw", lambda: pedersen.rnd_scalar_tensor(D, rng, DEVICE))
    last = stage("blindings_sum_on_card",
                 lambda: fe.to_numpy(sc.neg(sc.sum_reduce(torch.stack(vecs, dim=1), axis=0))))
    stage("blindings_one_blob_framing", lambda: sv.serialize_scalar_vec(last.reshape(16, D)))

    def python_integer_sum():
        total = [0] * D
        for v in vecs:
            total = [(t + x) % SS.L for t, x in zip(total, sc.unpack_scalars(v))]
        return sc.pack_scalars([-t for t in total])

    blindings_cancel &= bool(np.array_equal(stage("blindings_sum_python_integers",
                                                  python_integer_sum), last.reshape(16, D)))
    restore_counts(saved)  # measurements beside the path, not of it
    # The first client's commit also builds the two fixed-base tables.
    blobs = [stage(f"commit_client_{c}",
                   lambda: bindings.commit(updates[c], blindings[c], FP, device=DEVICE))
             for c in range(N_CLIENTS)]
    total = stage("add_commitments", lambda: bindings.add_commitments(blobs, device=DEVICE))
    got = stage("extract_values", lambda: bindings.extract_values(total, FP, device=DEVICE))
    pedersen_exact = bool(got.shape == (D,) and np.isfinite(got).all()
                          and np.array_equal(got, want))

    # The commitments are the reference group elements: first lanes against the spec.
    r0 = sv.deserialize_scalar_vec(blindings[0])
    spec_ok = True
    for lane in range(3):
        m = FP.f32_to_scalars(updates[0, lane:lane + 1])[0]
        r = fe.unpack_scalars(r0[:, lane:lane + 1])[0]
        enc = (G.pedersen_B().scalar_mul(m) + G.pedersen_B_blinding().scalar_mul(r)).compress()
        spec_ok &= blobs[0][8 + 40 * lane + 8: 8 + 40 * (lane + 1)] == enc

    # The sampler's XOF on the card gives the bytes the same code gives on the CPU.
    key = rng.bytes(32)
    xof_ok = bool(torch.equal(pedersen.xof_byte_cols(key, 77, DEVICE).cpu(),
                              pedersen.xof_byte_cols(key, 77, "cpu")))

    # ElGamal-pair form of the same round, through the wire format.
    def elgamal_round():
        acc = None
        for c in range(N_CLIENTS):
            m = fe.to_tensor(FP.f32_to_scalar_limbs(updates[c]), DEVICE)
            r = fe.to_tensor(sv.deserialize_scalar_vec(blindings[c]), DEVICE)
            wire = sv.serialize_eg_pair_vec(pedersen.elgamal_commit(m, r))
            pairs = sv.deserialize_eg_pair_vec(wire, DEVICE)
            acc = pairs if acc is None else pedersen.add_pairs(acc, pairs)
        cancelled = bool(pedersen.right_elem_is_identity(acc).all())
        limbs, ok = bsgs.solve_discrete_log(acc.L, FP.default_bsgs_table_size, FP.bsgs_n_bits)
        return cancelled, bool(ok.all()), FP.scalar_limbs_to_f32(fe.to_numpy(limbs))

    cancelled, found, got_eg = stage("elgamal_round", elgamal_round)
    elgamal_exact = bool(cancelled and found and np.array_equal(got_eg, want))

    # Small table: 2^16 / 2^12 = 16 giant steps on 4096 lanes.
    lanes = np.arange(SMALL_LANES)
    small_blob = bindings.select_commitments(total, lanes, device=DEVICE)
    before = dict(kernels.LAUNCHES)
    got_small = stage("extract_values_small_table", lambda: bindings.extract_values(
        small_blob, FP, table_size=SMALL_TABLE, device=DEVICE))
    small_launches = {k: kernels.LAUNCHES[k] - before[k] for k in before}
    giant_steps = (1 << FP.bsgs_n_bits) // SMALL_TABLE
    small_exact = bool(np.array_equal(got_small, want[:SMALL_LANES]))

    # Blindings that do not cancel (one client missing) must fail extraction.
    partial = bindings.add_commitments(
        [bindings.select_commitments(b, lanes[:REJECT_LANES], device=DEVICE)
         for b in blobs[:-1]],
        device=DEVICE)
    try:
        bindings.extract_values(partial, FP, table_size=SMALL_TABLE, device=DEVICE)
        rejected = False
    except ValueError:
        rejected = True

    counts = path_counts()
    launches = counts["launches"]
    result = {
        "phase": "round", "d": D, "clients": N_CLIENTS, "fp": [FP.n_bits, FP.n_frac],
        "bsgs_m": FP.default_bsgs_table_size, "small_table_m": SMALL_TABLE,
        "small_table_lanes": SMALL_LANES, "giant_steps": giant_steps,
        "small_table_launches": small_launches,
        "wire_bytes_per_client": len(blobs[0]),
        "blinding_launches": blinding_launches, "blindings_cancel": blindings_cancel,
        "pedersen_sum_exact": pedersen_exact, "commitments_match_spec": bool(spec_ok),
        "xof_matches_cpu": xof_ok,
        "elgamal_sum_exact": elgamal_exact, "small_table_sum_exact": small_exact,
        "uncancelled_round_rejected": rejected,
        "peak_device_bytes": torch.cuda.max_memory_allocated(),
        "seconds": seconds, "launches": launches, "lanes": counts["lanes"],
    }
    emit(result)
    checks = ("blindings_cancel", "pedersen_sum_exact", "commitments_match_spec",
              "xof_matches_cpu",
              "elgamal_sum_exact", "small_table_sum_exact", "uncancelled_round_rejected")
    failed = [c for c in checks if not result[c]]
    # two walks (the value and its negative), each of 16 steps: a compress per
    # step and an add of -mG between steps; the table build adds one compress
    # and a point_add a fixed-base window that holds k <= m (2 for m = 2^12)
    table_adds = -(-SMALL_TABLE.bit_length() // fixed_base.WINDOW_BITS)
    if (small_launches["compress"] < 2 * giant_steps + 1
            or small_launches["point_add"] < 2 * (giant_steps - 1) + table_adds):
        failed.append("giant steps did not run on the card")
    failed += [f"{name} was never launched" for name in ROUND_KERNELS if launches[name] == 0]
    if failed:
        sys.exit(f"round failed: {failed}")
    state = {"updates": updates, "blindings": blindings, "blobs": blobs}
    return counts, state


# -- phase 5: the Σ-protocol path -------------------------------------------------

SPEC_LANES = 3
TAMPERED_LANE = 4321


def spec_scalars(limbs, lanes=SPEC_LANES) -> list:
    return fe.unpack_scalars(fe.to_numpy(limbs)[:, :lanes])


def spec_challenge(label: bytes, messages: list) -> int:
    t = Transcript(label)
    t.append_message(*sigma.DOMAIN_SEP)
    for message_label, message in messages:
        t.append_message(message_label, message)
    return t.challenge_scalar(b"c")


def spec_square_lane(label: bytes, with_pair: bool, m, r1, r2, m_p, r1_p, r2_p, c_l=None):
    """One lane of a square-rand proof (with_pair) or a square proof, by the
    pure-Python spec → (commitment bytes, proof bytes)."""
    B, H = G.pedersen_B(), G.pedersen_B_blinding()
    c_l = c_l or B.scalar_mul(m) + H.scalar_mul(r1)
    c_sq = B.scalar_mul(m * m % SS.L) + H.scalar_mul(r2)
    c_l_prime = B.scalar_mul(m_p) + H.scalar_mul(r1_p)
    c_sq_prime = c_l.scalar_mul(m_p) + H.scalar_mul(r2_p)
    left = c_l.compress() + (B.scalar_mul(r1).compress() if with_pair else b"")
    left_prime = c_l_prime.compress() + (B.scalar_mul(r1_p).compress() if with_pair else b"")
    c = spec_challenge(label, [
        (b"C_eg", left), (b"C_ped", c_sq.compress()),
        (b"C_prime_eg", left_prime), (b"C_prime_ped", c_sq_prime.compress())])
    z = [(m_p + m * c) % SS.L, (r1_p + r1 * c) % SS.L, (r2_p + (r2 - m * r1) * c) % SS.L]
    return (left + c_sq.compress(),
            left_prime + c_sq_prime.compress() + b"".join(SS.to_bytes(v) for v in z))


def blob_rows(blob: bytes, width: int, lanes=SPEC_LANES) -> list:
    return [blob[8 + (8 + width) * i + 8: 8 + (8 + width) * (i + 1)] for i in range(lanes)]


def flip_bit(blob: bytes, width: int, lane: int, offset: int) -> bytes:
    """The blob with the lowest bit of one byte of one item flipped."""
    out = bytearray(blob)
    out[8 + (8 + width) * lane + 8 + offset] ^= 1
    return bytes(out)


def phase_sigma(state: dict) -> dict:
    rng = np.random.default_rng(SEED + 2)
    seconds = {}

    def stage(name, fn):
        out, seconds[name] = synced(fn)
        return out

    def primes(n_draws):
        """The primes the next prover will draw: the sampler is a function of
        the rng alone, so a copy of the rng gives them without touching it."""
        twin = np.random.default_rng()
        twin.bit_generator.state = rng.bit_generator.state
        saved = path_counts()  # these draws are the check's, not the path's
        draws = [spec_scalars(pedersen.rnd_scalar_tensor(D, twin, DEVICE))
                 for _ in range(n_draws)]
        restore_counts(saved)
        return draws

    start_path()
    values = state["updates"][0]
    m_limbs = FP.f32_to_scalar_limbs(values)
    m_int = fe.unpack_scalars(m_limbs[:, :SPEC_LANES])
    b1 = bindings.create_random_blinding_vector(D, rng, device=DEVICE)
    b2 = bindings.create_random_blinding_vector(D, rng, device=DEVICE)
    r1_limbs, r2_limbs = sv.deserialize_scalar_vec(b1), sv.deserialize_scalar_vec(b2)
    r1_int, r2_int = spec_scalars(r1_limbs), spec_scalars(r2_limbs)
    m, r1, r2 = (fe.to_tensor(x, DEVICE) for x in (m_limbs, r1_limbs, r2_limbs))
    B, H = G.pedersen_B(), G.pedersen_B_blinding()
    checks = {}

    # -- rand proofs, through the bindings
    m_p, r_p = primes(2)
    proof, pairs = stage("create_randproof",
                         lambda: bindings.create_randproof(values, b1, FP, rng, device=DEVICE))
    left, right = stage("split_elgamal_pair_vector",
                        lambda: bindings.split_elgamal_pair_vector(pairs, device=DEVICE))
    checks["rand_proof_accepted"] = stage(
        "verify_randproof", lambda: bindings.verify_randproof(left, right, proof, device=DEVICE))
    checks["elgamal_join_is_split_inverse"] = (
        bindings.join_to_elgamal_pair_vector(left, right, device=DEVICE) == pairs)
    bad = flip_bit(proof, 128, TAMPERED_LANE, 64)  # one limb of z_m
    checks["tampered_rand_proof_refused"] = not bindings.verify_randproof(
        left, right, bad, device=DEVICE)
    mask = sigma.rand_proof_verify(
        sv.deserialize_rand_proof_vec(bad, DEVICE), sv.deserialize_eg_pair_vec(pairs, DEVICE))
    checks["tampered_rand_proof_refused_in_its_lane_only"] = (
        int((~mask).sum()) == 1 and not bool(mask[TAMPERED_LANE]))
    spec_ok = True
    for i in range(SPEC_LANES):
        c_bytes = ((B.scalar_mul(m_int[i]) + H.scalar_mul(r1_int[i])).compress()
                   + B.scalar_mul(r1_int[i]).compress())
        cp_bytes = ((B.scalar_mul(m_p[i]) + H.scalar_mul(r_p[i])).compress()
                    + B.scalar_mul(r_p[i]).compress())
        c = spec_challenge(b"RandProof", [(b"C", c_bytes), (b"C_prime", cp_bytes)])
        want = (cp_bytes + SS.to_bytes((m_p[i] + m_int[i] * c) % SS.L)
                + SS.to_bytes((r_p[i] + r1_int[i] * c) % SS.L))
        spec_ok &= blob_rows(pairs, 64)[i] == c_bytes and blob_rows(proof, 128)[i] == want
    checks["rand_proof_matches_spec"] = spec_ok
    wire = {"rand_proof": len(proof), "elgamal_pairs": len(pairs)}

    # -- square-rand proofs, through the bindings
    sq_primes = primes(3)
    sq_proof, triples = stage("create_squarerandproof", lambda: bindings.create_squarerandproof(
        values, b1, b2, FP, rng, device=DEVICE))
    checks["square_rand_proof_accepted"] = stage(
        "verify_squarerandproof",
        lambda: bindings.verify_squarerandproof(triples, sq_proof, device=DEVICE))
    parts = stage("split_squaretriple_pair_vector",
                  lambda: bindings.split_squaretriple_pair_vector(triples, device=DEVICE))
    checks["squaretriple_join_is_split_inverse"] = stage(
        "join_to_squaretriple_pair_vector",
        lambda: bindings.join_to_squaretriple_pair_vector(*parts, device=DEVICE)) == triples
    checks["tampered_square_rand_proof_refused"] = not bindings.verify_squarerandproof(
        triples, flip_bit(sq_proof, 192, TAMPERED_LANE, 96 + 64), device=DEVICE)  # z_r2
    # a square commitment to m in place of m^2: only lanes with m^2 == m may pass
    c_vec = sv.deserialize_squaretriple_vec(triples, DEVICE)
    p_vec = sv.deserialize_square_rand_proof_vec(sq_proof, DEVICE)
    mask = sigma.square_rand_proof_verify(
        p_vec, sigma.SquareRandCommitVec(c_vec.c, pedersen.pedersen_commit(m, r2)))
    m_is_its_square = sc.eq(sc.mul(m, m), m)
    checks["commitment_to_m_for_m_squared_refused"] = bool(
        torch.equal(mask, m_is_its_square) and int((~mask).sum()) > D // 2)
    spec_ok = True
    for i in range(SPEC_LANES):
        want_c, want_p = spec_square_lane(
            b"SquareRandProof", True, m_int[i], r1_int[i], r2_int[i],
            *[draw[i] for draw in sq_primes])
        spec_ok &= blob_rows(triples, 96)[i] == want_c and blob_rows(sq_proof, 192)[i] == want_p
    checks["square_rand_proof_matches_spec"] = spec_ok
    wire.update({"square_rand_proof": len(sq_proof), "square_rand_commitments": len(triples)})

    # -- square proofs, through crypto.sigma and the codec
    sq_primes = primes(3)
    s_proof, s_commit = stage("square_proof_prove",
                              lambda: sigma.square_proof_prove(m, r1, r2, rng))
    s_blob = stage("serialize_square_proof_vec", lambda: sv.serialize_square_proof_vec(s_proof))
    s_proof = sv.deserialize_square_proof_vec(s_blob, DEVICE)
    mask = stage("square_proof_verify", lambda: sigma.square_proof_verify(s_proof, s_commit))
    checks["square_proof_accepted"] = bool(mask.all())
    mask = sigma.square_proof_verify(
        s_proof, sigma.SquareCommitVec(s_commit.c_l, pedersen.pedersen_commit(m, r2)))
    checks["square_commitment_to_m_refused"] = bool(torch.equal(mask, m_is_its_square))
    spec_ok = True
    s_commit_rows = np.concatenate([curve.compress_to_bytes(s_commit.c_l),
                                    curve.compress_to_bytes(s_commit.c_sq)], axis=1)
    for i in range(SPEC_LANES):
        want_c, want_p = spec_square_lane(
            b"SquareProof", False, m_int[i], r1_int[i], r2_int[i],
            *[draw[i] for draw in sq_primes])
        spec_ok &= s_commit_rows[i].tobytes() == want_c and blob_rows(s_blob, 160)[i] == want_p
    checks["square_proof_matches_spec"] = spec_ok
    wire["square_proof"] = len(s_blob)

    # -- the existing= form on the round's own commitments (client 0)
    r0 = fe.to_tensor(sv.deserialize_scalar_vec(state["blindings"][0]), DEVICE)
    existing = sv.deserialize_rp_vec(state["blobs"][0], DEVICE)
    e_proof, e_pairs = stage("rand_proof_prove_existing",
                             lambda: sigma.rand_proof_prove(m, r0, rng, existing=existing))
    checks["existing_commitments_kept"] = (
        sv.serialize_rp_vec(e_pairs.L) == state["blobs"][0])
    checks["existing_rand_proof_accepted"] = bool(stage(
        "rand_proof_verify_existing", lambda: sigma.rand_proof_verify(e_proof, e_pairs)).all())
    # the same proof against the pairs of another blinding must fail in every lane
    checks["existing_rand_proof_refused_for_other_pairs"] = not bool(
        sigma.rand_proof_verify(e_proof, sv.deserialize_eg_pair_vec(pairs, DEVICE)).any())

    # -- the square-rand transcript apart from the rest of prove and verify
    messages = stage("square_rand_transcript_compress", lambda: [
        (b"C_eg", sigma.eg_byte_cols(c_vec.c)), (b"C_ped", sigma.point_byte_cols(c_vec.c_sq)),
        (b"C_prime_eg", sigma.eg_byte_cols(p_vec.c_prime)),
        (b"C_prime_ped", sigma.point_byte_cols(p_vec.c_sq_prime))])
    stage("square_rand_transcript", lambda: sigma.challenges(b"SquareRandProof", messages))
    rand_messages = [(b"C", messages[0][1]), (b"C_prime", messages[2][1])]
    stage("rand_transcript", lambda: sigma.challenges(b"RandProof", rand_messages))

    counts = path_counts()
    launches = counts["launches"]
    want_wire = {"rand_proof": 8 + 136 * D, "elgamal_pairs": 8 + 72 * D,
                 "square_rand_proof": 8 + 200 * D, "square_rand_commitments": 8 + 104 * D,
                 "square_proof": 8 + 168 * D}
    checks["wire_sizes"] = wire == want_wire
    result = {"phase": "sigma", "d": D, "fp": [FP.n_bits, FP.n_frac], "spec_lanes": SPEC_LANES,
              "tampered_lane": TAMPERED_LANE, "wire_bytes": wire, **checks,
              "peak_device_bytes": torch.cuda.max_memory_allocated(),
              "seconds": seconds, "launches": launches, "lanes": counts["lanes"]}
    emit(result)
    failed = [name for name, ok in checks.items() if not ok]
    failed += [f"{name} was never launched" for name in SIGMA_KERNELS if launches[name] == 0]
    if failed:
        sys.exit(f"sigma failed: {failed}")
    return counts


# -- phase 6: the L2-norm client round ----------------------------------------------

L2_SEED = 7
L2_CFG = P.CryptoConfig(value_range=8, n_partition=16, l2_value_range=16, check_percentage=1.0,
                        enc_type=P.ENC_L2_TYPE, fp=FP)
L2_KERNELS = ("msm_flat", "msm_groups", "scalar_mul", "compress", "point_sum", "sc_sum")
KAT_PATH = "tests/data/torch_port_l2_kat.json"
SMALL_D = 7


def l2_wire_bytes(enc: P.EncParamsL2) -> int:
    """The length EncParamsL2.serialize must have, from its parts: each field
    a one-byte tag, a varint length and its bytes; the two int32 fields a tag
    and a one-byte varint; then the varint length prefix of the message."""
    def varint_len(n):
        return max(1, (n.bit_length() + 6) // 7)

    fields = [96 * enc.enc_values.c_sq.x.shape[1], 192 * enc.square_proofs.z_m.shape[1]]
    fields += [len(p.to_bytes()) for p in enc.range_proofs + [enc.square_range_proof]]
    payload = sum(1 + varint_len(n) + n for n in fields) + 2 + 2
    return varint_len(payload) + payload


def phase_l2() -> dict:
    rng = np.random.default_rng(L2_SEED)
    seconds = {}

    def stage(name, fn):
        out, seconds[name] = synced(fn)
        return out

    # bench.py's element scale (l2rangeproof_bench.rs:44-49): the fixed-point
    # squared norm stays inside the 16-bit window; the crypto cost does not
    # depend on the values
    elem = (FP.l2_clip_bound(16) / D) ** 0.5 / FP.scale / 10.0
    vals = rng.uniform(-elem, elem, D).astype(np.float32)
    blind = pedersen.rnd_scalar_tensor(D, rng, DEVICE)

    def round_trip(prefix):
        enc = stage(f"{prefix}encrypt", lambda: P.EncParamsL2.encrypt(vals, blind, L2_CFG, rng,
                                                                      DEVICE))
        data = stage(f"{prefix}serialize", enc.serialize)
        dec = stage(f"{prefix}deserialize", lambda: P.EncParamsL2.deserialize(data, FP, DEVICE))
        ok = stage(f"{prefix}verify", lambda: dec.verify(rng))
        return enc, data, dec, ok

    _, _, _, warm_ok = round_trip("warmup_")
    start_path()
    enc, data, dec, ok = round_trip("")
    torch.cuda.synchronize()
    counts = path_counts()
    launches = counts["launches"]
    peak = torch.cuda.max_memory_allocated()
    checks = {"warmup_round_verifies": bool(warm_ok), "honest_round_verifies": bool(ok),
              "wire_bytes_match_parts": len(data) == l2_wire_bytes(enc)}

    # the stages of encrypt and verify, each timed apart on this round's data
    clipped = RPV.clip_f32_to_range_vec(vals, FP, L2_CFG.value_range)
    r2 = pedersen.rnd_scalar_tensor(D, rng, DEVICE)
    _, commits = stage("encrypt.range_proofs", lambda: RPV.create_rangeproof(
        clipped, blind, FP, L2_CFG.value_range, L2_CFG.n_partition, rng, DEVICE))
    stage("encrypt.l2_sum_proof", lambda: L2RP.create_rangeproof_l2(
        clipped, r2, FP, L2_CFG.l2_value_range, rng, DEVICE))
    m = fe.to_tensor(FP.f32_to_scalar_limbs(clipped), DEVICE)
    stage("encrypt.square_rand_prove", lambda: sigma.square_rand_proof_prove(
        m, blind, r2, rng, existing=commits))
    stage("verify.square_rand_batched", lambda: sigma.square_rand_proof_verify_batched(
        dec.square_proofs, dec.enc_values, rng))
    stage("verify.range_proofs", lambda: RPV.verify_rangeproof(
        dec.range_proofs, dec.enc_values.c.L, FP, dec.prove_range, rng))
    sum_pt = curve.unpack_points(curve.tree_sum(dec.enc_values.c_sq))[0]
    stage("verify.l2_sum_proof", lambda: L2RP.verify_rangeproof_l2(
        dec.square_range_proof, sum_pt, dec.l2_prove_range, rng, DEVICE))

    # a flipped bit in one chunk's range proof (the lowest bit of t_x_blinding)
    chunk = len(dec.range_proofs) // 3
    raw = bytearray(dec.range_proofs[chunk].to_bytes())
    raw[5 * 32] ^= 1
    bad = P.EncParamsL2(dec.enc_values, dec.square_proofs,
                        dec.range_proofs[:chunk] + [RP.RangeProof.from_bytes(bytes(raw))]
                        + dec.range_proofs[chunk + 1:], dec.square_range_proof, dec.prove_range,
                        dec.l2_prove_range, FP)
    checks["flipped_range_proof_bit_refused"] = not bad.verify(rng)
    # one lane of z_r2 plus one
    lane = fe.to_tensor(sc.pack_scalars([1]), DEVICE)
    z_r2 = dec.square_proofs.z_r2.clone()
    z_r2[:, D // 2:D // 2 + 1] = sc.add(z_r2[:, D // 2:D // 2 + 1].contiguous(), lane)
    tampered = sigma.SquareRandProofVec(dec.square_proofs.c_prime, dec.square_proofs.c_sq_prime,
                                        dec.square_proofs.z_m, dec.square_proofs.z_r1, z_r2)
    checks["tampered_square_rand_lane_refused"] = not sigma.square_rand_proof_verify_batched(
        tampered, dec.enc_values, rng)
    # every value at the edge of the 8-bit range: the fixed-point squared sum
    # (50000 * 127^2) wraps the 16-bit window. At L2 range 16 with
    # FpConfig(16, 7) the decoded sum never exceeds the bound, so the JAX
    # package's check_l2 raises L2OverflowError for these values (held equal
    # on the CPU by tests/test_torch_l2_params.py)
    try:
        P.EncParamsL2.encrypt(np.full(D, 0.99, np.float32), blind, L2_CFG, rng, DEVICE)
        checks["out_of_bounds_raises_l2_overflow_error"] = False
    except L2RP.L2OverflowError:
        checks["out_of_bounds_raises_l2_overflow_error"] = True

    # the JAX package's round (d = 7, 2 partitions), committed, on the card
    with open(KAT_PATH) as f:
        kat = json.load(f)
    kat_fp = FpConfig(*kat["fp"])
    kat_round = P.EncParamsL2.deserialize(bytes.fromhex(kat["params"]["serialized"]), kat_fp,
                                          DEVICE)
    checks["jax_kat_round_verifies_on_card"] = stage("kat_verify", lambda: kat_round.verify(rng))
    # a small round made on the card verifies on the CPU
    small_cfg = P.CryptoConfig(value_range=kat["value_range"], n_partition=kat["n_partition"],
                               l2_value_range=kat["l2_value_range"], fp=kat_fp,
                               enc_type=P.ENC_L2_TYPE)
    small_vals = np.asarray(kat["values"], np.float32)[:SMALL_D]
    small = P.EncParamsL2.encrypt(small_vals, pedersen.rnd_scalar_tensor(SMALL_D, rng, DEVICE),
                                  small_cfg, rng, DEVICE)
    checks["card_small_round_verifies_on_cpu"] = stage(
        "small_round_verify_on_cpu",
        lambda: P.EncParamsL2.deserialize(small.serialize(), kat_fp, "cpu").verify(rng))

    prove_s, verify_s = seconds["encrypt"], seconds["verify"]
    result = {
        "phase": "l2", "d": D, "n_partition": L2_CFG.n_partition, "value_range": 8,
        "l2_value_range": 16, "fp": [FP.n_bits, FP.n_frac], "seed": L2_SEED,
        "metric": "l2_path_prove_verify_s_d50000", "value": prove_s + verify_s,
        "prove_s": prove_s, "verify_s": verify_s, "wire_bytes": len(data), **checks,
        "peak_device_bytes": peak, "seconds": seconds, "launches": launches,
        "lanes": counts["lanes"],
    }
    emit(result)
    failed = [name for name, ok in checks.items() if not ok]
    failed += [f"{name} was never launched" for name in L2_KERNELS if launches[name] == 0]
    if failed:
        sys.exit(f"l2 failed: {failed}")
    return counts, prove_s + verify_s


# -- phase 7: the server round in the other encrypted modes -------------------------

MODES_SEED = 11
MODES_CLIENTS = 3
MODES = (("enc_range", P.ENC_RANGE_TYPE), ("enc_range_compressed", P.ENC_RANGE_COMPRESSED_TYPE),
         ("enc_l2_compressed", P.ENC_L2_COMPRESSED_TYPE))
MODES_KERNELS = ("point_add", "compress", "decompress", "sc_reduce_wide", "sc_mul", "sc_add",
                 "msm_flat", "msm_groups", "point_sum", "sc_sum")
# the per-lane ladder: EncRange's rand-proof verify, EncL2Compressed's square proofs
LADDER_MODES = ("enc_range", "enc_l2_compressed")
# EncL2Compressed's updates must also pass the L2 bound at L2 range 16: the sum
# of the squared fixed-point values stays below 2^16, so almost every lane is
# +-1 unit (2^-7) and the first L2_WIDE_LANES lanes +-2 units.
L2_WIDE_LANES = 3000


def modes_cfg(enc_type: int, check_percentage: float = 1.0) -> P.CryptoConfig:
    return P.CryptoConfig(value_range=8, n_partition=16, l2_value_range=16,
                          check_percentage=check_percentage, enc_type=enc_type, fp=FP)


def mode_bits(enc_type: int, rng: np.random.Generator) -> np.ndarray:
    """(clients, D) fixed-point updates, none 0: inside the 8-bit range
    (|bits| <= 127) for the Range modes, inside the L2 bound for
    EncL2Compressed."""
    sign = rng.choice([-1, 1], size=(MODES_CLIENTS, D))
    if enc_type == P.ENC_L2_COMPRESSED_TYPE:
        mag = np.ones((MODES_CLIENTS, D), np.int64)
        mag[:, :L2_WIDE_LANES] = 2
    else:
        mag = rng.integers(1, 128, size=(MODES_CLIENTS, D))
    return sign * mag


def frame_bytes(byte_fields: list, ints: list, floats: int = 0) -> int:
    """The length of a length-delimited envelope from its parts: each bytes
    field a one-byte tag, a varint length and its bytes; each int32 a tag and
    its varint; each float a tag and 4 bytes; then the varint length prefix."""
    def varint_len(n):
        return max(1, (n.bit_length() + 6) // 7)

    payload = (sum(1 + varint_len(n) + n for n in byte_fields)
               + sum(1 + varint_len(v) for v in ints) + 5 * floats)
    return varint_len(payload) + payload


def mode_wire_bytes(enc) -> int:
    ranges = [len(p.to_bytes()) for p in enc.range_proofs]
    if isinstance(enc, P.EncParamsL2Compressed):
        d = enc.enc_values.c_sq.x.shape[1]
        return frame_bytes([96 * d, 160 * d, 128] + ranges + [len(enc.square_range_proof.to_bytes())],
                           [enc.prove_range, enc.l2_prove_range])
    d = enc.enc_values.L.x.shape[1]
    rand = 128 * d if isinstance(enc, P.EncParamsRange) else 128
    return frame_bytes([64 * d, rand] + ranges, [enc.prove_range], floats=1)


def flipped(enc):
    """The update with one bit of its rand proof flipped: the lowest bit of
    one lane's z_m (EncRange), of the compressed proof's z_m (the compressed
    modes)."""
    return flipped_rand_proof(enc, TAMPERED_LANE)


def phase_modes(l2_metric: float) -> dict:
    rng = np.random.default_rng(MODES_SEED)
    result = {"phase": "modes", "d": D, "clients": MODES_CLIENTS, "fp": [FP.n_bits, FP.n_frac],
              "n_partition": 16, "value_range": 8, "l2_value_range": 16, "check_percentage": 1.0,
              "seed": MODES_SEED, "l2_path_prove_verify_s_d50000": l2_metric, "modes": {}}
    counts_by_mode, failed = {}, []
    for mode, enc_type in MODES:
        seconds, checks = {}, {}

        def stage(name, fn):
            out, seconds[name] = synced(fn)
            return out

        bits = mode_bits(enc_type, rng)
        updates = (bits / FP.scale).astype(np.float32)
        blindings = pedersen.cancelling_scalar_limbs(MODES_CLIENTS, D, rng, DEVICE)
        cfg = modes_cfg(enc_type)
        start_path()
        acc = P.Accumulator(enc_type, D, FP, device=DEVICE)
        decoded, wire_ok, sizes = [], True, []
        for c in range(MODES_CLIENTS):
            enc = stage(f"client_{c}.encrypt", lambda: P.encrypt(
                enc_type, updates[c], blindings[c], cfg, rng, DEVICE))
            data = stage(f"client_{c}.serialize", enc.serialize)
            dec = stage(f"client_{c}.deserialize", lambda: P.deserialize(
                enc_type, data, FP, DEVICE))
            checks[f"client_{c}_verifies"] = bool(stage(f"client_{c}.verify",
                                                        lambda: P.verify(dec, rng)))
            checks[f"client_{c}_accumulated"] = bool(stage(f"client_{c}.accumulate",
                                                           lambda: acc.accumulate(dec)))
            wire_ok &= len(data) == mode_wire_bytes(enc)
            sizes.append(len(data))
            decoded.append(dec)
        got = stage("extract", acc.extract)
        torch.cuda.synchronize()
        counts_by_mode[mode] = path_counts()
        launches = counts_by_mode[mode]["launches"]
        peak = torch.cuda.max_memory_allocated()

        # JAX's accumulator starts from (B, B), so its L holds B^(1 + sum m)
        want = ((bits.sum(axis=0) + 1) / FP.scale).astype(np.float32)
        checks["extract_exact"] = bool(got is not None and got.shape == (D,)
                                       and np.isfinite(got).all() and np.array_equal(got, want))
        checks["wire_bytes_match_parts"] = bool(wire_ok)
        checks["flipped_rand_proof_refused"] = not P.verify(flipped(decoded[0]), rng)
        partial = P.Accumulator(enc_type, D, FP, device=DEVICE)
        for dec in decoded[:-1]:
            partial.accumulate(dec)
        checks["uncancelled_accumulator_extracts_none"] = partial.extract() is None
        checks["wrong_size_refused"] = not P.Accumulator(enc_type, D - 1, FP,
                                                         device=DEVICE).accumulate(decoded[0])
        if enc_type == P.ENC_RANGE_TYPE:
            half = P.encrypt(enc_type, updates[0], blindings[0], modes_cfg(enc_type, 0.5), rng,
                             DEVICE)
            back = stage("check_percentage_0.5.round_trip", lambda: P.deserialize(
                enc_type, half.serialize(), FP, DEVICE))
            checks["check_percentage_0.5_kept"] = back.check_percentage == 0.5
            checks["check_percentage_0.5_verifies"] = bool(
                stage("check_percentage_0.5.verify", lambda: P.verify(back, rng)))
            checks["check_percentage_0.5_covers_half"] = (
                sum(len(p.to_bytes()) for p in back.range_proofs) < sum(
                    len(p.to_bytes()) for p in decoded[0].range_proofs))
        last = f"client_{MODES_CLIENTS - 1}"
        metric = f"{mode}_prove_verify_s_d50000"
        result["modes"][mode] = {
            "enc_type": enc_type, metric: seconds[f"{last}.encrypt"] + seconds[f"{last}.verify"],
            "prove_s": seconds[f"{last}.encrypt"], "verify_s": seconds[f"{last}.verify"],
            "extract_s": seconds["extract"], "wire_bytes": sizes[0], **checks,
            "peak_device_bytes": peak, "seconds": seconds, "launches": launches,
            "lanes": counts_by_mode[mode]["lanes"]}
        failed += [f"{mode}: {name}" for name, ok in checks.items() if not ok]
        need = MODES_KERNELS + (("scalar_mul",) if mode in LADDER_MODES else ())
        failed += [f"{mode}: {name} was never launched" for name in need if launches[name] == 0]
        del decoded, acc, partial
        torch.cuda.empty_cache()
    emit(result)
    if failed:
        sys.exit(f"modes failed: {failed}")
    return counts_by_mode


# -- phase 8: the device mesh ----------------------------------------------------

MESH_SEED = 71
MESH_SHARDS = 4  # the virtual mesh: cuda:0 four times
MESH_ODD_SHARDS = 3  # 300 000 terms split evenly, 50 000 padded by 2
MESH_SCALING_SHARDS = ("2", "4")
MESH_KAT_PATH = "tests/data/torch_port_mesh_kat.json"
MESH_KERNELS = ("point_add", "compress", "decompress", "sc_reduce_wide", "sc_mul", "sc_add",
                "sc_sub", "scalar_mul", "msm_flat", "msm_groups", "point_sum", "sc_sum")


def card_mesh(shards: int) -> pmesh.Mesh:
    return pmesh.param_mesh(shards, [torch.device(DEVICE, 0)] * shards)


def encodings(p) -> bytes:
    return curve.compress_to_bytes(p).tobytes()


def phase_mesh() -> dict:
    """(a) sharded_msm of the l2 verifier's 300 000 terms (and their first
    50 000) equals msm.msm at 4 and 3 shards and on every card; (b) one
    EncParamsL2 round verified with the mesh, a tampered one refused, the
    range proofs made with the mesh equal to those made without it; (c) the
    rand and square-rand proofs at d = 50000 over 3 shards equal to the
    unsharded ones; (d) the dry run on a 2 x 2 mesh of the card, stages 2-5
    at d = 50000, its stage 1 on the JAX package's updates equal to the
    JAX mesh's; (e) the scaling table at d = 50000, 16 partitions, 1/2/4
    shards. Launches are counted on the mesh-routed calls; the unsharded
    calls they are held against are not counted."""
    rng = np.random.default_rng(MESH_SEED)
    virtual, odd, cards = card_mesh(MESH_SHARDS), card_mesh(MESH_ODD_SHARDS), pmesh.param_mesh()
    seconds, checks = {}, {}

    def stage(name, fn):
        out, seconds[name] = synced(fn)
        return out

    def unsharded(fn):
        """fn() without adding its launches to the path's counts."""
        saved = path_counts()
        out = fn()
        torch.cuda.synchronize()
        restore_counts(saved)
        return out

    elem = (FP.l2_clip_bound(16) / D) ** 0.5 / FP.scale / 10.0
    vals = rng.uniform(-elem, elem, D).astype(np.float32)
    blind = pedersen.rnd_scalar_tensor(D, rng, DEVICE)
    enc = P.EncParamsL2.encrypt(vals, blind, L2_CFG, rng, DEVICE)
    dec = P.EncParamsL2.deserialize(enc.serialize(), FP, DEVICE)
    rho = pedersen.rnd_scalar_tensor(3 * D, rng, DEVICE)
    pts, scal, _, _ = sigma.square_rand_batch_terms(b"SquareRandProof", dec.square_proofs,
                                                    dec.enc_values, rho)
    torch.cuda.synchronize()
    start_path()

    # (a) the l2 verifier's 6N-term MSM, and its first 50 000 terms
    for terms in (6 * D, D):
        p = PointArray(*[c[:, :terms].contiguous() for c in pts])
        k = scal[:, :terms].contiguous()
        want = encodings(unsharded(lambda: stage(f"msm_{terms}_without_mesh",
                                                 lambda: msm.msm(p, k))))
        for name, mesh in (("4", virtual), ("3", odd), ("cards", cards)):
            got = stage(f"sharded_msm_{terms}_{name}", lambda: pmesh.sharded_msm(mesh, p, k))
            checks[f"sharded_msm_{terms}_{name}_shards_equal"] = encodings(got) == want

    # (b) verify with and without the mesh, a tampered copy, the mesh prover
    for prefix in ("warmup_", ""):
        checks[f"{prefix}l2_verify_without_mesh"] = unsharded(lambda: stage(
            f"{prefix}verify_without_mesh", lambda: dec.verify(rng)))
        checks[f"{prefix}l2_verify_with_mesh"] = stage(
            f"{prefix}verify_with_mesh", lambda: dec.verify(rng, virtual))
    raw = bytearray(dec.range_proofs[5].to_bytes())
    raw[5 * 32] ^= 1
    bad = P.EncParamsL2(dec.enc_values, dec.square_proofs,
                        dec.range_proofs[:5] + [RP.RangeProof.from_bytes(bytes(raw))]
                        + dec.range_proofs[6:], dec.square_range_proof, dec.prove_range,
                        dec.l2_prove_range, FP)
    checks["flipped_range_proof_bit_refused_with_mesh"] = not bad.verify(rng, virtual)
    clipped = RPV.clip_f32_to_range_vec(vals, FP, L2_CFG.value_range)

    def range_proofs(mesh):
        proofs, commits = RPV.create_rangeproof(clipped, blind, FP, L2_CFG.value_range,
                                                L2_CFG.n_partition,
                                                np.random.default_rng(MESH_SEED + 1), DEVICE,
                                                mesh)
        return [p.to_bytes() for p in proofs], encodings(commits)

    want = unsharded(lambda: stage("create_rangeproof_without_mesh", lambda: range_proofs(None)))
    for name, mesh in (("4", virtual), ("cards", cards)):
        checks[f"create_rangeproof_{name}_shards_equal"] = stage(
            f"create_rangeproof_{name}", lambda: range_proofs(mesh)) == want

    # (c) the Σ-proofs over 3 shards (50000 = 3 * 16667 - 1)
    m = fe.to_tensor(FP.f32_to_scalar_limbs(clipped), DEVICE)
    r2 = pedersen.rnd_scalar_tensor(D, rng, DEVICE)

    def rand(mesh):
        p, c = sigma.rand_proof_prove(m, blind, np.random.default_rng(MESH_SEED + 2), mesh=mesh)
        return p, c, bool(sigma.rand_proof_verify(p, c, mesh=mesh).all())

    def square_rand(mesh):
        p, c = sigma.square_rand_proof_prove(m, blind, r2, np.random.default_rng(MESH_SEED + 3),
                                             mesh=mesh)
        return p, c, bool(sigma.square_rand_proof_verify(p, c, mesh=mesh).all())

    (rp0, rc0, ok0), (sp0, sc0, sok0) = unsharded(lambda: (rand(None), square_rand(None)))
    rp, rc, ok = stage("rand_proof_3_shards", lambda: rand(odd))
    sp, scm, sok = stage("square_rand_proof_3_shards", lambda: square_rand(odd))
    checks["rand_proofs_verify"] = ok0 and ok
    checks["rand_proof_3_shards_equal"] = (
        torch.equal(rp.z_m, rp0.z_m) and torch.equal(rp.z_r, rp0.z_r)
        and all(encodings(a) == encodings(b) for a, b in (
            (rc.L, rc0.L), (rc.R, rc0.R), (rp.c_prime.L, rp0.c_prime.L),
            (rp.c_prime.R, rp0.c_prime.R))))
    checks["square_rand_proofs_verify"] = sok0 and sok
    checks["square_rand_proof_3_shards_equal"] = (
        all(torch.equal(a, b) for a, b in ((sp.z_m, sp0.z_m), (sp.z_r1, sp0.z_r1),
                                           (sp.z_r2, sp0.z_r2)))
        and all(encodings(a) == encodings(b) for a, b in (
            (scm.c.L, sc0.c.L), (scm.c.R, sc0.c.R), (scm.c_sq, sc0.c_sq),
            (sp.c_prime.L, sp0.c_prime.L), (sp.c_prime.R, sp0.c_prime.R),
            (sp.c_sq_prime, sp0.c_sq_prime))))

    # (d) the dry run on a 2 x 2 mesh of the card
    lines = []
    dry = stage("dryrun", lambda: dryrun.dryrun_multichip(
        4, [torch.device(DEVICE, 0)] * 4, d=D, log=lines.append))
    torch.cuda.synchronize()
    counts = path_counts()
    with open(MESH_KAT_PATH) as f:
        kat = json.load(f)["dryrun"]
    kat_mesh = pmesh.make_mesh(kat["clients"], kat["param"], [torch.device(DEVICE, 0)] * (
        kat["clients"] * kat["param"]))
    kat_encs = [fe.to_tensor(FP.f32_to_scalar_limbs(np.asarray(u, np.float64) / FP.scale),
                             DEVICE) for u in kat["units"]]
    agg, agg_ok = dryrun.commit_stage(kat_mesh, kat_encs)
    checks["dryrun_stage1_on_jax_updates_equals_jax_mesh"] = (
        bool(agg_ok.all()) and hashlib.sha256(encodings(agg)).hexdigest() == kat["agg_sha256"])
    port_units = [np.rint(u.double().cpu().numpy() * FP.scale).astype(np.int64)
                  for u in dryrun.client_updates(kat_mesh)[0]]
    checks["dryrun_updates_within_a_unit_of_jax"] = all(
        np.abs(a - np.asarray(b)).max() <= 1 for a, b in zip(port_units, kat["units"]))

    # (e) the scaling table
    with tempfile.TemporaryDirectory() as out, contextlib.redirect_stdout(io.StringIO()):
        table = stage("scaling_table", lambda: scaling_table.main(
            ["--d", str(D), "--parts", "16", "--shards", *MESH_SCALING_SHARDS, "--out",
             os.path.join(out, "SCALING.md")]))
    restore_counts(counts)
    emit({"scaling_table": {k: table[k] for k in ("prove", "verify", "sigma")},
          "d": D, "parts": 16})

    verify_s, plain_verify_s = seconds["verify_with_mesh"], seconds["verify_without_mesh"]
    result = {
        "phase": "mesh", "d": D, "n_partition": L2_CFG.n_partition, "fp": [FP.n_bits, FP.n_frac],
        "seed": MESH_SEED, "meshes": {"virtual": pmesh.describe(virtual),
                                      "odd": pmesh.describe(odd), "cards": pmesh.describe(cards)},
        "metric": "mesh_l2_verify_s_d50000", "value": verify_s,
        "mesh_l2_verify_s_d50000": verify_s, "l2_verify_without_mesh_s": plain_verify_s,
        "dryrun": dry, "dryrun_log": lines, **checks, "seconds": seconds,
        "launches": counts["launches"], "lanes": counts["lanes"]}
    emit(result)
    failed = [name for name, ok in checks.items() if not ok]
    failed += [f"{name} was never launched" for name in MESH_KERNELS
               if counts["launches"][name] == 0]
    if failed:
        sys.exit(f"mesh failed: {failed}")
    return counts


# -- phase 9: the FL runtime: server and clients over gRPC -------------------------

FL_SEED = 41
FL_CLIENTS = 4  # num_clients of configs/mnist_range_e2e.yml and mnist_l2_compressed.yml
FL_ROUNDS = 1  # and the tampered round; cut from 2 to keep the script inside its time
FL_MODEL = "models/resnet18_intrinsic_50k.txt"
FL_KERNELS = ("point_add", "compress", "decompress", "sc_reduce_wide", "sc_mul", "sc_add",
              "sc_sub", "scalar_mul", "msm_flat", "msm_groups", "point_sum", "sc_sum")
FL_TIMEOUT_S = 300.0


class SeededTrainer:
    """A client's trainer: each round an update of 0 or +-1 unit of 2^-7 a
    lane, drawn from its own seed (inside the 8-bit range; at d = 50000 the
    sum of squares stays under the L2 bound of 2^16 units); keeps the units
    it returned."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)
        self.bits: dict[int, np.ndarray] = {}

    async def train_for_round(self, config, model: np.ndarray, round_id: int) -> np.ndarray:
        self.bits[round_id] = self.rng.integers(-1, 2, size=len(model))
        return (self.bits[round_id] / FP.scale).astype(np.float32)


class RoundsSeen:
    """The observer's evaluator: keeps each broadcast model."""

    def __init__(self):
        self.models: list[np.ndarray] = []

    def set_weights(self, w):
        self.models.append(w.copy())

    def evaluate(self):
        return 0.0, 0.0


def fl_config(initial: np.ndarray, rounds: int) -> ServerConfig:
    return ServerConfig(
        model_id=1, num_clients=FL_CLIENTS, num_rounds=rounds, learning_rate=1.0,
        enc_type=P.ENC_L2_TYPE, initial_model=initial, lazy_verification=False,
        verification_threads=1, write_model_file=False, bench_dir=None, device=DEVICE,
        crypto=P.CryptoConfig(value_range=8, n_partition=16, l2_value_range=16,
                              check_percentage=1.0, enc_type=P.ENC_L2_TYPE, fp=FP))


async def fl_run(initial: np.ndarray, rounds: int, rng: np.random.Generator, tampered=()):
    """One server, FL_CLIENTS clients and an observer in this event loop,
    over gRPC on 127.0.0.1; until the server is done or has
    failed. Returns (state, clients, trainers, seen, broadcast times)."""
    # The four clients share this interpreter, and every launch releases the
    # GIL: four encrypts at once on the card took 55-57 s each, against
    # 2.6-5.5 s one at a time (PERF.md §5). So the loop's default executor,
    # on which a client encrypts, runs one encrypt at a time, as four client
    # processes would not share one GIL.
    asyncio.get_running_loop().set_default_executor(ThreadPoolExecutor(1))
    state = TrainingState(fl_config(initial, rounds))
    marks: list[float] = []  # perf_counter at each model broadcast and at DONE
    for name in ("broadcast_global_model", "broadcast_done"):
        def timed(broadcast=getattr(state, name)):
            marks.append(time.perf_counter())
            return broadcast()
        setattr(state, name, timed)
    blindings = {r: pedersen.cancelling_scalar_limbs(FL_CLIENTS, D, rng, DEVICE)
                 for r in range(rounds)}
    server = make_server({1: state}, "127.0.0.1:0")
    await server.start()
    address = f"127.0.0.1:{server.port}"
    seen = RoundsSeen()
    observer = FLObserver(address, 1, seen)
    tasks = [asyncio.create_task(observer.observe())]
    try:
        while not state.observer_queues:
            await asyncio.sleep(0.01)
        trainers = [SeededTrainer(FL_SEED + 100 * rounds + i) for i in range(FL_CLIENTS)]
        clients = [FlServiceClient(address, 1, i, trainers[i], device=DEVICE,
                                   blinding_fn=lambda r, n, i=i: blindings[r][i])
                   for i in range(FL_CLIENTS)]
        for i in tampered:
            flip_middle_byte(clients[i])
        tasks += [asyncio.create_task(c.train_model()) for c in clients]
        await asyncio.wait_for(state.done_event.wait(), FL_TIMEOUT_S)
        if state.status == "done":
            await asyncio.wait_for(asyncio.gather(*tasks), FL_TIMEOUT_S)
        torch.cuda.synchronize()
    finally:
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        await server.stop(0.5)
        state.close()
    return state, clients, trainers, seen, marks, observer


def fl_server_ms(deltas: list) -> dict:
    """A round's TimeState deltas, named: the server records each upload as
    it arrives, then the last accumulate, the extract and the update (after
    the eager wait for the round's verifications)."""
    n = FL_CLIENTS - 1
    return {"uploads_after_the_first": deltas[:n], "to_last_accumulate": deltas[n],
            "extract": deltas[n + 1], "verify_wait_and_update": deltas[n + 2]}


def fl_client_stages(log: dict) -> dict:
    """A client's round: its TimeState deltas, named, and its upload."""
    names = ("receive_ms", "train_ms", "encrypt_ms", "send_ms")
    return {**dict(zip(names, log["deltas_ms"])), "upload_bytes": log["sent_bytes"],
            "data_blocks": log["blocks"]}


def phase_fl() -> dict:
    """Four clients, FL_ROUNDS EncL2 rounds at d = 50000 through the server, then
    one round with a tampered upload."""
    rng = np.random.default_rng(FL_SEED)
    initial = read_model_from_file(FL_MODEL)
    start_path()
    t0 = time.perf_counter()
    state, clients, trainers, seen, marks, observer = asyncio.run(
        fl_run(initial, FL_ROUNDS, rng))
    wall = time.perf_counter() - t0
    counts = path_counts()
    launches = counts["launches"]
    peak = torch.cuda.max_memory_allocated()

    checks = {"initial_model_d50000": initial.shape == (D,) and initial.dtype == np.float32,
              "status_done": state.status == "done",
              "clients_done": [c.done_status for c in clients] == [wire.STATUS_DONE] * FL_CLIENTS,
              "observer_saw_every_round": [e[0] for e in observer.evals] == list(range(FL_ROUNDS))}
    want = initial.copy()
    for r in range(FL_ROUNDS):
        # the accumulator's (B, B) start adds one unit to the clients' sum
        units = sum(t.bits[r] for t in trainers) + 1
        extracted = (units / FP.scale).astype(np.float32)
        got = next((s.extracted for s in state.rounds if s.round_id == r), None)
        checks[f"round_{r}_extract_exact"] = bool(
            got is not None and got.shape == (D,) and np.isfinite(got).all()
            and np.array_equal(got, extracted))
        checks[f"observer_round_{r}_model"] = bool(
            r < len(seen.models) and np.array_equal(seen.models[r], want))
        want = want + extracted * (1.0 / FL_CLIENTS) * 1.0  # the server's float32 rule
    checks["final_model_bit_equal_to_numpy_replay"] = bool(
        state.global_model.dtype == np.float32 and np.array_equal(state.global_model, want))
    rounds = sorted(state.rounds, key=lambda s: s.round_id)
    result = {
        "phase": "fl", "d": D, "clients": FL_CLIENTS, "rounds": FL_ROUNDS, "enc_type": "EncL2",
        "transport": "grpc", "address": "127.0.0.1", "model": FL_MODEL,
        "fp": [FP.n_bits, FP.n_frac],
        "n_partition": 16, "value_range": 8, "l2_value_range": 16, "check_percentage": 1.0,
        "verification": "eager, 1 thread", "seed": FL_SEED,
        "fl_round_s_d50000": [b - a for a, b in zip(marks, marks[1:])],
        "wall_s": wall,
        "server_ms": {r.round_id: fl_server_ms(r.time_state.deltas_ms()) for r in rounds},
        "client_stages": {c.client_id: {r: fl_client_stages(log)
                                        for r, log in sorted(c.round_log.items())}
                          for c in clients},
        "peak_device_bytes": peak, **checks, "launches": launches, "lanes": counts["lanes"]}

    # the same settings, one round, client 1 flips a byte in its upload
    tampered, _, _, _, _, _ = asyncio.run(fl_run(initial, 1, rng, tampered=(1,)))
    restore_counts(counts)
    checks["tampered_round_failed"] = tampered.status == "failed"
    checks["tampered_model_unchanged"] = bool(np.array_equal(tampered.global_model, initial))
    result.update({k: checks[k] for k in ("tampered_round_failed", "tampered_model_unchanged")})
    emit(result)
    failed = [name for name, ok in checks.items() if not ok]
    failed += [f"{name} was never launched" for name in FL_KERNELS if launches[name] == 0]
    if failed:
        sys.exit(f"fl failed: {failed}")
    return counts


# -- phase 10: the training path: a YAML experiment, trainer services, GrpcTrainer ----

TRAIN_CONFIG = "configs/mnist_range_e2e.yml"
LAZY_CONFIG = "configs/mnist_l2_compressed.yml"
TRAIN_ROUNDS = 1  # (a): the file says 5
LAZY_ROUNDS = 2  # (b) and (c): the file says 5; lazy verification needs a second round
TRAIN_CLIENTS = 4
LAZY_CLIENTS = 2  # (b) and (c): the file says 4; client 1 is the tampered one
TRAIN_SEED = 61
TRAIN_KERNELS = MODES_KERNELS + ("scalar_mul",)
TRAIN_TIMEOUT_S = 600.0
MODELS_KAT = "tests/data/torch_port_models_kat.npz"
KAT_THETA0_ULPS = 8  # the normals' erf⁻¹ is XLA's polynomial, within a few ulps
KAT_STEP_REL = 1e-4  # of the step's largest component: products summed in another order
KAT_LOSS_RTOL = 1e-5


class RecordingTrainer:
    """A client's trainer (``GrpcTrainer``) that keeps each round's update."""

    def __init__(self, inner):
        self.inner = inner
        self.updates: dict[int, np.ndarray] = {}

    async def train_for_round(self, config, model, round_id):
        self.updates[round_id] = await self.inner.train_for_round(config, model, round_id)
        return self.updates[round_id]


def cli_args(*argv):
    """The arguments the CLI would parse for `argv`, on the card."""
    return cli.parser().parse_args([*argv, "--device", DEVICE])


async def train_run(cfg: ServerConfig, services, evaluator, tamper_round=None):
    """One experiment in this event loop, as the CLI's commands run it in
    their processes: the server of `cfg`, one trainer service a client
    (``make_train_server``), a client a service, whose trainers are
    ``GrpcTrainer``s (zero blindings, as ``cli clients``), and an observer
    with `evaluator`. With `tamper_round`, client 1's rand proof is flipped
    in that round. Returns (state, clients, trainers, observer, broadcast
    times)."""
    # as cli.cmd_clients: the encrypts take turns on a one-thread executor;
    # the trainer services' training runs on the same default executor
    asyncio.get_running_loop().set_default_executor(ThreadPoolExecutor(1))
    state = TrainingState(cfg)
    marks: list[float] = []
    for name in ("broadcast_global_model", "broadcast_done"):
        def timed(broadcast=getattr(state, name)):
            marks.append(time.perf_counter())
            return broadcast()
        setattr(state, name, timed)
    server = make_server({cfg.model_id: state}, "127.0.0.1:0")
    await server.start()
    address = f"127.0.0.1:{server.port}"
    trainer_servers = [make_train_server(svc, "127.0.0.1:0") for svc in services]
    for ts in trainer_servers:
        await ts.start()
    observer = FLObserver(address, cfg.model_id, evaluator)
    tasks = [asyncio.create_task(observer.observe())]
    try:
        while not state.observer_queues:
            await asyncio.sleep(0.01)
        trainers = [RecordingTrainer(GrpcTrainer(f"127.0.0.1:{ts.port}"))
                    for ts in trainer_servers]
        clients = [FlServiceClient(address, cfg.model_id, i, trainers[i], device=DEVICE)
                   for i in range(len(services))]
        for i, c in enumerate(clients):
            c.rng = np.random.default_rng(TRAIN_SEED + i)
        if tamper_round is not None:
            flip_rand_proof(clients[1], tamper_round)
        tasks += [asyncio.create_task(c.train_model()) for c in clients]
        await asyncio.wait_for(state.done_event.wait(), TRAIN_TIMEOUT_S)
        if state.status == "done":
            await asyncio.wait_for(asyncio.gather(*tasks), TRAIN_TIMEOUT_S)
        torch.cuda.synchronize()
    finally:
        for t in tasks:
            t.cancel()
        await asyncio.gather(*tasks, return_exceptions=True)
        for ts in trainer_servers:
            await ts.stop(0.5)
        await server.stop(0.5)
        state.close()
    return state, clients, trainers, observer, marks


def fixed_point_units(update: np.ndarray, cfg: P.CryptoConfig) -> np.ndarray:
    """The signed fixed-point units a client commits to: its update clipped
    to the proven range, then round-half-even."""
    clipped = RPV.clip_f32_to_range_vec(update, cfg.fp, cfg.value_range)
    return np.where(clipped < 0, -1, 1) * cfg.fp.f32_to_bits(clipped).astype(np.int64)


def replay_checks(state, trainers, cfg: ServerConfig, rounds: int, prefix: str = "") -> dict:
    """Each extracted sum against the clients' fixed-point sum plus the
    accumulator's one unit, and the global model against the numpy float32
    replay of the server's rule over the first `rounds` rounds."""
    checks, want = {}, cfg.initial_model.astype(np.float32).copy()
    scale = cfg.crypto.fp.scale
    for r in range(rounds):
        units = sum(fixed_point_units(t.updates[r], cfg.crypto) for t in trainers) + 1
        extracted = (units / scale).astype(np.float32)
        got = next((s.extracted for s in state.rounds if s.round_id == r), None)
        checks[f"{prefix}round_{r}_extract_exact"] = bool(
            got is not None and np.array_equal(got, extracted))
        want = want + extracted * (1.0 / cfg.num_clients) * cfg.learning_rate
    checks[f"{prefix}model_bit_equal_to_numpy_replay"] = bool(
        state.global_model.dtype == np.float32 and np.array_equal(state.global_model, want))
    return checks


# 32-bit operations a normal of P needs at least: threefry2x32's 20 rounds
# (an add, a rotate as two shifts and an or, a xor: 100), its key injections
# (15) and the xor of its two words (1); the uniform map (a shift, an or, a
# subtract, a multiply-add, a max: 6); erf⁻¹ (a log1p counted as 20, 8
# multiply-adds as 16, 4 more); the two scalings (2). About 165.
P_OPS_A_NORMAL = 165


def p_generation_bound(d: int, D: int) -> dict:
    """The least time the card could make P in (rows below D, d columns):
    the larger of its float32 bytes written once over the memory rate and
    its operations over the 32-bit integer peak."""
    n = d * D
    bytes_ms = 1e3 * 4 * n / HBM_BYTES_PER_S
    ops_ms = 1e3 * P_OPS_A_NORMAL * n / INT32_OPS_PER_S
    return {"normals": n, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_ms": max(bytes_ms, ops_ms), "bound_by": "operations" if ops_ms > bytes_ms
            else "bytes"}


def trainer_breakdown(trainer, batch) -> dict:
    """One client's step apart, on the card: the generation of P (twice a
    step: forward and transpose), the two projections with it, the network's
    forward and backward at θ, the SGD update; ms, median of 3."""
    d, D, seed = trainer.intrinsic.d, trainer.intrinsic.D, trainer.intrinsic.seed
    xb, yb = batch
    z = torch.as_tensor(trainer.weights, device=DEVICE)
    theta = trainer.intrinsic.theta(z).detach()

    def gen():
        for _ in intrinsic.projection_tiles(d, D, seed, DEVICE):
            pass

    def net():
        th = theta.clone().requires_grad_(True)
        with trainer_mod.float32_products(DEVICE):
            loss = trainer_mod.cross_entropy(functional_call(
                trainer.module, networks.unflatten(trainer.module, th), (xb,)), yb)
            torch.autograd.grad(loss, th)

    g = torch.randn(D, device=DEVICE)
    calls = {"p_generation": gen,
             "project": lambda: intrinsic.project_forward(z, D, seed),
             "project_transpose": lambda: intrinsic.project_transpose(g, d, seed),
             "network_forward_backward": net,
             "step": lambda: trainer.step(z, xb, yb),
             "sgd_update": lambda: z - trainer.lr * z}
    return {name: 1e3 * statistics.median(synced(fn)[1] for _ in range(3))
            for name, fn in calls.items()}


def check_models_kat() -> dict:
    """θ0 of mnist_dev and one intrinsic SGD step at d = 5000, on the card,
    against the JAX package's values in the models KAT."""
    kat = np.load(MODELS_KAT)
    seed, rnd, batch = int(kat["meta/seed"]), int(kat["meta/round"]), int(kat["meta/batch"])
    t = Trainer("mnist_dev_intrinsic", "mnist", client_id=int(kat["meta/client_id"]),
                num_clients=int(kat["meta/clients"]), batch_size=batch, seed=seed,
                intrinsic_dim=5000, device=DEVICE)
    theta0 = t.intrinsic.theta0.cpu().numpy()
    want = kat["theta0/mnist_dev"]
    ulps = float(np.max(np.abs(theta0 - want) / np.spacing(np.abs(want))))
    w0, w1_want = kat["mnist_dev_intrinsic_5000/w0"], kat["mnist_dev_intrinsic_5000/w1"]
    order = np.random.default_rng(rnd).permutation(len(t.x))[:batch]
    _, loss = t.step(torch.as_tensor(w0, device=DEVICE), t._x[torch.as_tensor(order, device=DEVICE)],
                     t._y[torch.as_tensor(order, device=DEVICE)])
    t.set_weights(w0)
    w1 = t.train(rnd)
    step_err = float(np.max(np.abs(w1 - w1_want)) / np.max(np.abs(w1_want - w0)))
    loss_want = float(kat["mnist_dev_intrinsic_5000/loss0"])
    return {"theta0_max_ulps": ulps, "theta0_ulps_limit": KAT_THETA0_ULPS,
            "step_max_err_over_step": step_err, "step_limit": KAT_STEP_REL,
            "loss": float(loss), "loss_jax": loss_want,
            "kat_theta0_within_limit": ulps <= KAT_THETA0_ULPS,
            "kat_step_within_limit": step_err <= KAT_STEP_REL,
            "kat_loss_within_limit": abs(float(loss) - loss_want) <= KAT_LOSS_RTOL * abs(loss_want)}


def phase_train() -> dict:
    """(a) configs/mnist_range_e2e.yml for 2 rounds with four trainer
    services on the card; (b) configs/mnist_l2_compressed.yml, lazy, with
    dummy trainer services, 2 honest rounds; (c) the same with client 1's
    rand proof flipped in round 0, which must fail at round 1's finalize."""
    exp = load_experiment(TRAIN_CONFIG, device=DEVICE)
    cfg = exp.server
    cfg.num_rounds = TRAIN_ROUNDS
    cfg.verification_threads = cli_args("server", "-c", TRAIN_CONFIG).vthreads
    cfg.write_model_file, cfg.bench_dir = False, None
    dim = int(exp.intrinsic_dimension)
    t0 = time.perf_counter()
    services = [cli.make_train_service(cli_args(
        "trainservice", "--model", exp.model_name, "--dataset", exp.dataset,
        "--intrinsic-dim", str(dim), "--client-id", str(i), "--num-clients", str(TRAIN_CLIENTS)))
        for i in range(TRAIN_CLIENTS)]
    evaluator = cli.make_evaluator(cli_args("observer", "--model", exp.model_name,
                                            "--dataset", exp.dataset,
                                            "--intrinsic-dim", str(dim)))
    setup_s = time.perf_counter() - t0
    start_path()
    t0 = time.perf_counter()
    state, clients, trainers, observer, marks = asyncio.run(train_run(cfg, services, evaluator))
    wall = time.perf_counter() - t0
    counts = path_counts()
    launches = counts["launches"]
    peak = torch.cuda.max_memory_allocated()

    checks = {"config_d5000": cfg.num_params == dim == 5000 and cfg.enc_type == P.ENC_RANGE_TYPE,
              "status_done": state.status == "done",
              "clients_done": [c.done_status for c in clients] == [wire.STATUS_DONE] * TRAIN_CLIENTS,
              "updates_finite_nonzero": all(
                  np.isfinite(u).all() and np.any(u != 0) and u.shape == (dim,)
                  for t in trainers for u in t.updates.values()) and all(
                  sorted(t.updates) == list(range(TRAIN_ROUNDS)) for t in trainers),
              "observer_loss_finite_every_round": (
                  [e[0] for e in observer.evals] == list(range(TRAIN_ROUNDS))
                  and all(math.isfinite(e[1]) for e in observer.evals))}
    checks.update(replay_checks(state, trainers, cfg, TRAIN_ROUNDS))
    rounds = sorted(state.rounds, key=lambda s: s.round_id)
    trainer_rounds = {i: svc.trainer.round_log for i, svc in enumerate(services)}
    xb = services[0].trainer._x[:services[0].trainer.batch_size]
    yb = services[0].trainer._y[:services[0].trainer.batch_size]
    breakdown = trainer_breakdown(services[0].trainer, (xb, yb))
    steps = services[0].trainer.round_log[0]["steps"]
    result = {
        "phase": "train", "config": TRAIN_CONFIG, "reduced": {"num_rounds": [5, TRAIN_ROUNDS]},
        "enc_type": "EncRange", "d": dim, "D": services[0].trainer.full_dim,
        "model": exp.model_name, "dataset": exp.dataset, "clients": TRAIN_CLIENTS,
        "n_partition": cfg.crypto.n_partition, "value_range": cfg.crypto.value_range,
        "trainer": {"lr": services[0].trainer.lr, "batch": services[0].trainer.batch_size,
                    "epochs": services[0].trainer.local_epochs, "steps_a_round": steps},
        "verification": f"eager, {cfg.verification_threads} threads", "blindings": "zero",
        "setup_s": setup_s, "train_round_s": [b - a for a, b in zip(marks, marks[1:])],
        "wall_s": wall,
        "trainer_round_ms": trainer_rounds,
        "trainer_step_ms": breakdown,
        "p_generation_bound": p_generation_bound(dim, services[0].trainer.full_dim),
        "trainer_round_ms_from_steps": {k: steps * v for k, v in breakdown.items()},
        "server_ms": {r.round_id: r.time_state.deltas_ms() for r in rounds},
        "client_stages": {c.client_id: {r: fl_client_stages(log)
                                        for r, log in sorted(c.round_log.items())}
                          for c in clients},
        "observer": [{"round": r, "loss": loss, "accuracy": acc}
                     for r, loss, acc in observer.evals],
        "peak_device_bytes": peak, "launches": launches, "lanes": counts["lanes"]}

    # (b) lazy verification, honest; (c) the same with a tampered round 0
    lazy = load_experiment(LAZY_CONFIG, lazy_eval=True, device=DEVICE).server
    lazy.num_rounds, lazy.write_model_file, lazy.bench_dir = LAZY_ROUNDS, False, None
    lazy.verification_threads = cfg.verification_threads
    lazy.num_clients = LAZY_CLIENTS
    dummies = [DummyTrainService() for _ in range(LAZY_CLIENTS)]
    t0 = time.perf_counter()
    honest, lazy_clients, lazy_trainers, _, lazy_marks = asyncio.run(
        train_run(lazy, dummies, None))
    lazy_wall = time.perf_counter() - t0
    checks["lazy_status_done"] = honest.status == "done"
    checks.update(replay_checks(honest, lazy_trainers, lazy, LAZY_ROUNDS, prefix="lazy_"))
    tampered, _, tampered_trainers, _, _ = asyncio.run(
        train_run(lazy, dummies, None, tamper_round=0))
    restore_counts(counts)
    finished = sorted(s.round_id for s in tampered.rounds if s.is_done())
    checks["tampered_lazy_failed"] = tampered.status == "failed"
    checks["tampered_lazy_failed_at_round_1_finalize"] = finished == [0] and any(
        s.round_id == 1 and s.extracted is not None for s in tampered.rounds)
    checks.update(replay_checks(tampered, tampered_trainers, lazy, 1,
                                prefix="tampered_round_0_applied_"))
    result.update({"lazy": {"config": LAZY_CONFIG, "enc_type": "EncL2Compressed",
                            "trainer": "DummyTrainService", "round_s":
                            [b - a for a, b in zip(lazy_marks, lazy_marks[1:])],
                            "wall_s": lazy_wall, "clients": LAZY_CLIENTS,
                            "reduced": {"num_rounds": [5, LAZY_ROUNDS],
                                        "num_clients": [4, LAZY_CLIENTS]},
                            "server_ms": {r.round_id: r.time_state.deltas_ms()
                                          for r in sorted(honest.rounds,
                                                          key=lambda s: s.round_id)},
                            "client_stages": {c.client_id: {
                                r: fl_client_stages(log) for r, log in sorted(c.round_log.items())}
                                for c in lazy_clients}}})
    result["models_kat"] = check_models_kat()
    checks.update({k: v for k, v in result["models_kat"].items() if k.startswith("kat_")})
    result.update(checks)
    emit(result)
    failed = [name for name, ok in checks.items() if not ok]
    failed += [f"{name} was never launched" for name in TRAIN_KERNELS if launches[name] == 0]
    if failed:
        sys.exit(f"train failed: {failed}")
    return counts


# -- phase 11: the micro-benchmark suite ---------------------------------------

MICRO_DIM = 32768  # the first of the reference's dims (bench_constants.rs)
# bench_l2rangeproof draws values up to 1/64 of the clip bound; at range 8
# their squared sum passes the L2 bound only below d = 256, in both packages
# (reference hazard 14): it runs at 128, and must raise L2NormError at 32768.
MICRO_L2_DIM = 128
MICRO_RUNS = 16  # the 11 benches' create and verify runs
MICRO_KERNELS = FL_KERNELS


def phase_micro(smi: str) -> dict:
    """``bench_suite.main`` for all 11 benches at d = 32768 (l2rangeproof at
    128), one sample each after its warm-up, on the card, into a temporary
    directory. Its verify samples raise on a refused proof; each file must
    hold one integer line."""
    common = ["--samples", "1", "--device", DEVICE]
    others = [name for name in bench_suite.BENCHES if name != "l2rangeproof"]
    with tempfile.TemporaryDirectory() as out:
        start_path()
        t0 = time.perf_counter()
        results = bench_suite.main(["--bench", *others, "--dims", str(MICRO_DIM), "--out", out,
                                    *common])
        results += bench_suite.main(["--bench", "l2rangeproof", "--dims", str(MICRO_L2_DIM),
                                     "--out", out, *common])
        wall = time.perf_counter() - t0
        counts = path_counts()
        files = {}
        for name in sorted(os.listdir(out)):
            with open(os.path.join(out, name)) as f:
                files[name] = f.read().splitlines()
        try:
            bench_suite.main(["--bench", "l2rangeproof", "--dims", str(MICRO_DIM), "--out", out,
                              *common])
            l2_raised = False
        except L2RP.L2NormError:
            l2_raised = True
        restore_counts(counts)
    launches = counts["launches"]
    runs = [r["name"] for r in results]
    checks = {
        "every_bench_ran": len(results) == MICRO_RUNS and len(set(runs)) == MICRO_RUNS,
        "a_file_a_run": sorted(os.path.basename(r["file"]) for r in results) == list(files),
        "one_integer_line_a_file": all(len(lines) == 1 and lines[0].isdigit()
                                       for lines in files.values()),
        "verify_samples_passed": sum(n.startswith("verify-") for n in runs) == 7
        and "bench_paper_dlog2" in runs,
        "l2rangeproof_at_32768_raises_l2_norm_error": l2_raised,
    }
    result = {"phase": "micro", "nvidia_smi": smi, "d": MICRO_DIM,
              "d_l2rangeproof": MICRO_L2_DIM, "samples": 1,
              "fp": [FP.n_bits, FP.n_frac], "range": bench_suite.DEFAULT_RANGE,
              "ms": {r["name"]: r["ms"][0] for r in results},
              "bench_lines": {name: lines[0] for name, lines in files.items()},
              "wall_s": wall, **checks, "launches": launches, "lanes": counts["lanes"]}
    emit(result)
    failed = [name for name, ok in checks.items() if not ok]
    failed += [f"{name} was never launched" for name in MICRO_KERNELS if launches[name] == 0]
    if failed:
        sys.exit(f"micro failed: {failed}")
    return counts


# -- phase 12: the e2e suite, one process a role ---------------------------------

E2E_MODES = ("Plain", "Range", "l2Compressed")  # the JAX suite's default modes
E2E_CONFIG = "configs/example_config.yml"
E2E_CLIENTS = 4
E2E_ROUNDS = 2  # the suite's default is 3
E2E_TRAINERS = 1
E2E_TIMEOUT_S = 300.0
E2E_MEMORY_BYTES = 1.5e9  # four CUDA contexts and more, where the pids are hidden


def free_port_block(n: int) -> int:
    """A port p with p .. p + n - 1 all free on 127.0.0.1 now."""
    for base in range(20000 + os.getpid() % 20000, 60000, 97):
        socks = []
        try:
            for port in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", port))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError(f"no block of {n} free ports")


def smi_query(*args) -> list[list[str]]:
    out = subprocess.run(["nvidia-smi", *args, "--format=csv,noheader,nounits"], check=True,
                         capture_output=True, text=True).stdout
    return [[x.strip() for x in line.split(",")] for line in out.splitlines() if line.strip()]


class DeviceSampler:
    """``nvidia-smi`` every second in a thread: the compute processes with
    their memory, and the card's memory in use (MiB)."""

    def __init__(self):
        self.samples: list[dict] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def sample(self) -> dict:
        apps = [(int(pid), int(mib)) for pid, mib in
                smi_query("--query-compute-apps=pid,used_memory")
                if pid.isdigit() and mib.isdigit()]
        used = int(smi_query("--query-gpu=memory.used")[0][0])
        return {"apps": apps, "used_mib": used}

    def _run(self):
        while not self._stop.is_set():
            self.samples.append(self.sample())
            self._stop.wait(1.0)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join(30)


def read_lines(path: str) -> list[str]:
    """The non-blank lines of a file; none where there is no file."""
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [line for line in f.read().splitlines() if line.strip()]


def group_left(pid: int) -> bool:
    try:
        os.killpg(pid, 0)
    except ProcessLookupError:
        return False
    return True


def phase_e2e(smi: str) -> dict:
    """``run_e2e_suite`` over Plain, Range and l2Compressed: for each mode,
    ``run_e2e`` starts a server, a trainer service, an observer and one
    ``clients`` process of 4 clients, each ``python -m rofl_tpu_torch.cli
    --device cuda`` in its own process on this card, on
    configs/example_config.yml (mnist_dev, all 19 090 parameters, trained
    by ``TorchTrainService``) cut to 2 rounds."""
    own = os.getpid()
    torch.cuda.synchronize()
    sampler = DeviceSampler()
    baseline = sampler.sample()
    with tempfile.TemporaryDirectory() as out, sampler:
        t0 = time.perf_counter()
        rows, outcomes = run_e2e_suite.main([
            "--modes", *E2E_MODES, "--clients", str(E2E_CLIENTS), "--rounds", str(E2E_ROUNDS),
            "--trainers", str(E2E_TRAINERS), "--config", E2E_CONFIG, "--out", out,
            "--port", str(free_port_block(10 * len(E2E_MODES))),
            "--timeout", str(E2E_TIMEOUT_S), "--device", DEVICE])
        wall = time.perf_counter() - t0
        bench_lines = {}
        for mode in E2E_MODES:
            logdir = os.path.join(out, f"benchlog_{mode}")
            bench_lines[mode] = {}
            for i in range(E2E_CLIENTS):
                bench_lines[mode][i] = len(read_lines(os.path.join(logdir, f"client{i}.bench")))
            bench_lines[mode]["server_ms"] = [
                [float(x) for x in line.split(",")]
                for line in read_lines(os.path.join(logdir, "benchlog", "server_model1.bench"))]
    # The card's processes before the phase (this one, under whatever pid
    # the container shows) are not children; the children's contexts are
    # let go of within seconds of their deaths.
    before = {pid for pid, _ in baseline["apps"]} | {own}
    deadline = time.monotonic() + 30
    while True:
        left_on_card = [pid for pid, _ in sampler.sample()["apps"] if pid not in before]
        if not left_on_card or time.monotonic() > deadline:
            break
        time.sleep(1)
    children = [[(pid, mib) for pid, mib in s["apps"] if pid not in before]
                for s in sampler.samples]
    pids_visible = any(children)
    peak_processes = max((len(c) for c in children), default=0)
    peak_children_mib = max((sum(mib for _, mib in c) for c in children), default=0)
    peak_above_own_mib = max((s["used_mib"] for s in sampler.samples), default=0) \
        - baseline["used_mib"]
    by_mode = {row["mode"]: row for row in rows}
    plain_bytes = by_mode.get("Plain", {}).get("total_bandwidth_bytes", 0)
    checks = {
        "servers_exited_0_in_time": {m: o.ok for m, o in outcomes.items()} == {
            m: True for m in E2E_MODES},
        "client_bench_two_lines": all(lines[i] == E2E_ROUNDS for lines in bench_lines.values()
                                      for i in range(E2E_CLIENTS)),
        "accuracy_parsed": all(by_mode[m]["accuracy"] != "" for m in E2E_MODES),
        "encrypted_modes_send_more_than_plain": all(
            by_mode[m]["total_bandwidth_bytes"] > plain_bytes > 0 for m in E2E_MODES[1:]),
        "no_child_left": not any(group_left(pid) for o in outcomes.values() for pid in o.pids)
        and not left_on_card,
        "roles_on_the_card": peak_processes >= 4 if pids_visible
        else peak_above_own_mib * 2**20 >= E2E_MEMORY_BYTES,
    }
    result = {
        "phase": "e2e", "nvidia_smi": smi, "config": E2E_CONFIG, "modes": list(E2E_MODES),
        "clients": E2E_CLIENTS, "trainers": E2E_TRAINERS, "observer": True,
        "model": "mnist_dev (19 090 parameters)", "reduced": {"num_rounds": [3, E2E_ROUNDS]},
        "table": rows, "wall_s": wall,
        "mode_s": {m: o.seconds for m, o in outcomes.items()},
        "server_rc": {m: o.server_rc for m, o in outcomes.items()},
        "errors": {m: o.error for m, o in outcomes.items() if o.error},
        "bench_lines": bench_lines,
        "device_read": "processes" if pids_visible else "memory",
        "card_processes_before": sorted(before - {own}), "own_pid": own,
        "peak_child_processes": peak_processes, "left_on_card": left_on_card,
        "peak_children_mib": peak_children_mib if pids_visible else None,
        "peak_memory_above_own_mib": peak_above_own_mib, "samples": len(sampler.samples),
        "launches": "in the children's processes: not counted here", **checks}
    emit(result)
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        sys.exit(f"e2e failed: {failed}")
    return result


def main() -> None:
    PHASES.start()
    smi = phase_device()
    ptxas = phase_build()
    records = phase_kernels()
    round_counts, state = phase_round()
    sigma_counts = phase_sigma(state)
    l2_counts, l2_metric = phase_l2()
    counts_by_path = {"round": round_counts, "sigma": sigma_counts, "l2": l2_counts,
                      **phase_modes(l2_metric), "mesh": phase_mesh(), "fl": phase_fl(),
                      "train": phase_train(),
                      "micro": phase_micro(smi)}
    phase_e2e(smi)
    emit({"phases_s": PHASES.seconds, "total_s": sum(PHASES.seconds.values()),
          "limit_s": 1200})
    print(smi, flush=True)
    keys = ("name", "route", "source", "replaces", "launches", "launches_by_path", "lanes",
            "lanes_by_path", "match", "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "n", "checked_lanes")
    extra_keys = ("group", "window", "slices", "ms_at_131618", "bound_ms_at_131618", "slices_at_131618", "ms_at_4n", "scalars", "windows",
                  "scalar_mul_ms_same_inputs", "rotated_share", "valid_share", "replaces_also",
                  "chain_ms", "bound_bytes_ms", "bound_ops_ms", "layouts",
                  "l_minus_1_100001_equal", "ptxas")
    rows = []
    for name, rec in records.items():
        by_path = {path: c["launches"][name] for path, c in counts_by_path.items()}
        lanes_by_path = {path: c["lanes"][name] for path, c in counts_by_path.items()}
        rec = {**rec, **KERNEL_FACTS[name], "launches": sum(by_path.values()),
               "launches_by_path": by_path, "lanes": sum(lanes_by_path.values()),
               "lanes_by_path": lanes_by_path, "ptxas": ptxas.get(name)}
        rows.append({**{k: rec[k] for k in keys}, **{k: rec[k] for k in extra_keys if k in rec}})
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
