"""Microbenchmark suite — counterpart of ``rofl_tpu.bench_suite`` (the
reference's 14 cargo-bench harnesses, rofl_crypto/benches/*.rs, as 11
benches under the JAX package's names), on the port.

Each benchmark times N samples of one crypto operation at each dimension, after
one warm-up sample that is not recorded, and writes one line of integer
milliseconds a sample to ``<out>/<name>-<fp>[-<range>]-<dim>-(<date>).bench``:
the format of the reference's ``util::create_bench_file``
(rofl_crypto/src/util.rs:13-30), so its plotting scripts parse these files.
A sample ends with ``torch.cuda.synchronize()`` on the card, so it times the
work and not the queueing of its launches.

Usage:
  python -m rofl_tpu_torch.bench_suite --bench all --dims 32768 --samples 2
  python -m rofl_tpu_torch.bench_suite --bench addelgamal --dims 16 --device cpu
  python -m rofl_tpu_torch.bench_suite --list

``--out`` defaults to ``build/bench_suite``; ``--device`` to ``cuda``.
"""

from __future__ import annotations

import argparse
import datetime
import os
import time

import numpy as np
import torch

from .crypto import compressed_rand_proof as crp
from .crypto import l2_range_proof as l2
from .crypto import pedersen, sigma
from .crypto import range_proof_vec as rpv
from .crypto.fp_codec import FpConfig
from .ops import bsgs, fe
from .spec.merlin import Transcript
from .utils.profiling import device_trace, span

# reference dims (bench_constants.rs:1-16); override with --dims for quick runs
DEFAULT_DIMS = [32768, 131072, 524288]
DEFAULT_RANGE = 8
N_PARTITION_PART36 = 16  # rangeproof_part36_bench.rs:36


def _bench_file(out_dir: str, name: str, parts: list) -> str:
    """Reference label format (util.rs:13-30 + bench filenames): dims are
    zero-padded to 5 digits so the reference plot scripts parse unchanged."""
    os.makedirs(out_dir, exist_ok=True)
    date = datetime.datetime.now().strftime("%Y-%m-%d-%H-%M-%S")
    tag = "-".join(
        f"{p:05d}" if isinstance(p, int) and p >= 1000 else str(p)
        for p in parts
    )
    return os.path.join(out_dir, f"{name}-{tag}-({date}).bench")


def _record(path: str, ms: float):
    # integer ms per line, as elapsed().as_millis() writes them
    # (create_rangeproof_bench.rs:73-75); plot scripts parse with int().
    with open(path, "a") as f:
        f.write(f"{round(ms)}\n")


def _check(ok: bool, what: str) -> None:
    """The verify samples' assert, kept under ``python -O``."""
    if not ok:
        raise AssertionError(f"{what} refused an honest proof")


class Suite:
    """Shared state of the benchmarks, and what each run measured:
    ``results`` holds one dict a run (name, parts, file, ms of each sample
    as a float)."""

    def __init__(self, fp_bits: int, fp_frac: int, prove_range: int,
                 out_dir: str, samples: int, device="cuda"):
        self.fp = FpConfig(fp_bits, fp_frac)
        self.range = prove_range
        self.out = out_dir
        self.samples = samples
        self.device = device
        self.rng = np.random.default_rng(42)
        self.results: list[dict] = []

    # -- helpers ---------------------------------------------------------

    def rand_values(self, d: int) -> np.ndarray:
        lo, hi = self.fp.clip_bounds(self.range)
        return self.rng.uniform(lo, hi, d).astype(np.float32)

    def rand_blind_ints(self, d: int) -> list[int]:
        return fe.unpack_scalars(pedersen.rnd_scalar_limbs(d, self.rng, self.device))

    def scalar_limbs(self, d: int) -> torch.Tensor:
        return pedersen.rnd_scalar_tensor(d, self.rng, self.device)

    def value_limbs(self, d: int) -> torch.Tensor:
        return fe.to_tensor(self.fp.f32_to_scalar_limbs(self.rand_values(d)), self.device)

    def sync(self) -> None:
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()

    def run(self, name: str, parts: list, sample_fn, setup_fn=lambda: None):
        path = _bench_file(self.out, name, parts)
        print(f"[bench] {name} {parts} x{self.samples} -> {path}")
        state = setup_fn()
        sample_fn(state)  # warm-up: builds and first-call costs once
        self.sync()
        times = []
        for _ in range(self.samples):
            t0 = time.perf_counter()
            sample_fn(state)
            self.sync()
            ms = (time.perf_counter() - t0) * 1000.0
            _record(path, ms)
            times.append(ms)
            print(f"    {ms:.1f} ms")
        self.results.append({"name": name, "parts": parts, "file": path, "ms": times})


# -- benchmarks (reference file in parens) -----------------------------------


def bench_rangeproof(s: Suite, d: int, n_partition: int = 1,
                     tag: str = "create-rangeproof"):
    """(create_)rangeproof_bench.rs — per-param Bulletproofs L-inf."""
    values = s.rand_values(d)
    blind = s.scalar_limbs(d)

    def sample(_):
        return rpv.create_rangeproof(values, blind, s.fp, s.range,
                                     n_partition, s.rng, s.device)

    s.run(tag, [s.fp.n_bits, f"{s.range:02d}", d], sample)


def bench_verify_rangeproof(s: Suite, d: int, n_partition: int = 1,
                            tag: str = "verify-rangeproof"):
    values = s.rand_values(d)
    blind = s.scalar_limbs(d)
    proofs, commits = rpv.create_rangeproof(values, blind, s.fp, s.range,
                                            n_partition, s.rng, s.device)

    def sample(_):
        ok = rpv.verify_rangeproof(proofs, commits, s.fp, s.range, s.rng)
        _check(ok, tag)
        return ok

    s.run(tag, [s.fp.n_bits, f"{s.range:02d}", d], sample)


def bench_rangeproof_part36(s: Suite, d: int):
    """rangeproof_part36_bench.rs — 16 partitions."""
    bench_rangeproof(s, d, N_PARTITION_PART36, "create-rangeproof-part36")


def bench_verify_rangeproof_part36(s: Suite, d: int):
    bench_verify_rangeproof(s, d, N_PARTITION_PART36,
                            "verify-rangeproof-part36")


def bench_l2rangeproof(s: Suite, d: int):
    """l2rangeproof_bench.rs — single BP over the summed square."""
    lo, hi = s.fp.clip_bounds(s.range)
    # small values so the square-sum stays within the L2 bound
    values = s.rng.uniform(lo / 64, hi / 64, d).astype(np.float32)
    blind = s.rand_blind_ints(d)

    def sample(_):
        return l2.create_rangeproof_l2(values, blind, s.fp, s.range, s.rng, s.device)

    s.run("create-rangeproof-l2", [s.fp.n_bits, f"{s.range:02d}", d], sample)

    proof, commit = l2.create_rangeproof_l2(values, blind, s.fp, s.range,
                                            s.rng, s.device)

    def vsample(_):
        _check(l2.verify_rangeproof_l2(proof, commit, s.range, s.rng, s.device),
               "verify-rangeproof-l2")

    s.run("verify-rangeproof-l2", [s.fp.n_bits, f"{s.range:02d}", d], vsample)


def bench_randproof(s: Suite, d: int):
    """randproof_bench.rs / create_randproof_bench.rs."""
    m = s.value_limbs(d)
    r = s.scalar_limbs(d)

    def sample(_):
        return sigma.rand_proof_prove(m, r, s.rng)

    s.run("create-randproof", [s.fp.n_bits, d], sample)

    proof, c = sigma.rand_proof_prove(m, r, s.rng)

    def vsample(_):
        _check(bool(sigma.rand_proof_verify(proof, c).all()), "verify-randproof")

    s.run("verify-randproof", [s.fp.n_bits, d], vsample)


def bench_squarerandproof(s: Suite, d: int):
    """squarerandproof_bench.rs."""
    m, r1, r2 = s.value_limbs(d), s.scalar_limbs(d), s.scalar_limbs(d)

    def sample(_):
        return sigma.square_rand_proof_prove(m, r1, r2, s.rng)

    s.run("create-squarerandproof", [s.fp.n_bits, d], sample)

    proof, c = sigma.square_rand_proof_prove(m, r1, r2, s.rng)

    def vsample(_):
        _check(bool(sigma.square_rand_proof_verify(proof, c).all()),
               "verify-squarerandproof")

    s.run("verify-squarerandproof", [s.fp.n_bits, d], vsample)


def bench_squareproof(s: Suite, d: int):
    """squareproof_bench.rs — Pedersen-only square relation."""
    m, r1, r2 = s.value_limbs(d), s.scalar_limbs(d), s.scalar_limbs(d)

    def sample(_):
        return sigma.square_proof_prove(m, r1, r2, s.rng)

    s.run("create-squareproof", [s.fp.n_bits, d], sample)

    proof, c = sigma.square_proof_prove(m, r1, r2, s.rng)

    def vsample(_):
        _check(bool(sigma.square_proof_verify(proof, c).all()), "verify-squareproof")

    s.run("verify-squareproof", [s.fp.n_bits, d], vsample)


def bench_compressedrandproof(s: Suite, d: int):
    """compressedrandproof_bench.rs — O(1)-size randomness proof."""
    m = s.value_limbs(d)
    r = s.scalar_limbs(d)

    def sample(_):
        return crp.prove(Transcript(b"CompressedRandProof"), m, r, s.rng)

    s.run("create-compressedrandproof", [s.fp.n_bits, d], sample)

    proof, c = crp.prove(Transcript(b"CompressedRandProof"), m, r, s.rng)

    def vsample(_):
        _check(crp.verify(Transcript(b"CompressedRandProof"), proof, c),
               "verify-compressedrandproof")

    s.run("verify-compressedrandproof", [s.fp.n_bits, d], vsample)


def bench_addelgamal(s: Suite, d: int):
    """addelgamal_bench.rs / bench_paper_addelgamal — one client pair-add."""
    a = pedersen.elgamal_commit(s.value_limbs(d), s.scalar_limbs(d))
    b = pedersen.elgamal_commit(s.value_limbs(d), s.scalar_limbs(d))

    def sample(_):
        return pedersen.add_pairs(a, b)

    s.run("bench_paper_addelgamal", [d], sample)


def bench_dlog(s: Suite, d: int):
    """dlog_bench.rs / bench_paper_dlog2 — BSGS extraction, table 2^16."""
    table_m = 1 << 16
    # full signed clip range incl. negatives so the negative-walk fallback
    # of solve_discrete_log_with_neg is exercised (dlog_bench.rs semantics)
    vals = s.rand_values(d)
    limbs = s.fp.f32_to_scalar_limbs(vals)
    pts = pedersen.pedersen_commit_no_blinding(fe.to_tensor(limbs, s.device))

    def sample(_):
        out, ok = bsgs.solve_discrete_log(pts, table_m, s.fp.bsgs_n_bits)
        _check(bool(ok.all()), "bench_paper_dlog2")
        return out

    s.run("bench_paper_dlog2", [s.fp.bsgs_n_bits, table_m, d], sample)


BENCHES = {
    "rangeproof": bench_rangeproof,
    "verify-rangeproof": bench_verify_rangeproof,
    "rangeproof-part36": bench_rangeproof_part36,
    "verify-rangeproof-part36": bench_verify_rangeproof_part36,
    "l2rangeproof": bench_l2rangeproof,
    "randproof": bench_randproof,
    "squarerandproof": bench_squarerandproof,
    "squareproof": bench_squareproof,
    "compressedrandproof": bench_compressedrandproof,
    "addelgamal": bench_addelgamal,
    "dlog": bench_dlog,
}


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="rofl_tpu_torch.bench_suite")
    ap.add_argument("--bench", nargs="+", default=["all"],
                    help=f"one of {sorted(BENCHES)} or 'all'")
    ap.add_argument("--dims", nargs="+", type=int, default=DEFAULT_DIMS)
    ap.add_argument("--samples", type=int, default=2)
    ap.add_argument("--fp-bits", type=int, default=16)
    ap.add_argument("--fp-frac", type=int, default=7)
    ap.add_argument("--range", type=int, default=DEFAULT_RANGE)
    ap.add_argument("--out", default="build/bench_suite")
    ap.add_argument("--trace", default=None, metavar="LOGDIR",
                    help="capture a torch.profiler trace into LOGDIR (Chrome trace)")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where the crypto runs: cuda (the kernels) or cpu")
    return ap


def main(argv=None) -> list[dict] | None:
    """Run the benches; returns ``Suite.results`` (None for ``--list``)."""
    ap = parser()
    args = ap.parse_args(argv)

    if args.list:
        print("\n".join(sorted(BENCHES)))
        return None

    names = sorted(BENCHES) if "all" in args.bench else args.bench
    unknown = [n for n in names if n not in BENCHES]
    if unknown:
        ap.error(f"unknown bench(es) {unknown}; choose from "
                 f"{sorted(BENCHES)} or 'all'")
    s = Suite(args.fp_bits, args.fp_frac, args.range, args.out, args.samples, args.device)
    with device_trace(args.trace):
        for name in names:
            for d in args.dims:
                with span(f"{name}-{d}"):
                    BENCHES[name](s, d)
    return s.results


if __name__ == "__main__":
    main()
