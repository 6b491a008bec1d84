"""Fixed-point f32 ↔ scalar codec — semantics of rofl_crypto conversion32.rs.

Own copy of ``rofl_tpu.crypto.fp_codec`` (host numpy), with ``encode_device``
in torch.

The reference selects the fixed-point width/fraction at COMPILE time via
cargo features (fp.rs:8-137; ansible rebuilds per experiment). Here it is a
runtime `FpConfig` (SURVEY.md §5 calls this out explicitly).

Encoding (conversion32.rs:11-18): v ↦ Scalar(round_ties_even(|v|·2^frac),
saturating to [0, 2^n_bits-1]), negated in the scalar field if v < 0 —
sign-magnitude embedding into Z_l.
Decoding (conversion32.rs:24-34): sign = top byte of the canonical scalar
non-zero; magnitude = low n_bits of (±scalar).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..spec import scalar as SS


@dataclass(frozen=True)
class FpConfig:
    """Runtime fixed-point configuration (reference defaults: fp16/frac7,
    fp.rs:118-137)."""

    n_bits: int = 16
    n_frac: int = 7

    @property
    def max_bits(self) -> int:
        return (1 << self.n_bits) - 1

    @property
    def precomp_bias(self) -> int:
        """PRECOMP_BIAS per width (fp.rs:45,61,77,86): sizes the default
        BSGS table as 2^(bsgs_n_bits/2 + precomp_bias)."""
        return {8: 3, 16: 8, 32: 7, 64: 0}[self.n_bits]

    @property
    def bsgs_n_bits(self) -> int:
        """BSGS_N_BITS (fp.rs:63,84): fp32/fp64 walk a 16-bit lookup since
        individual parameters stay small even when the L2 sum needs width."""
        return min(self.n_bits, 16)

    @property
    def default_bsgs_table_size(self) -> int:
        """default_discrete_log_vec's m (bsgs32.rs:36-38)."""
        return 1 << (self.bsgs_n_bits // 2 + self.precomp_bias)

    @property
    def scale(self) -> float:
        return float(1 << self.n_frac)

    def clip_bounds(self, range_bits: int) -> tuple[float, float]:
        """±((2^(range-1) - 1) ulp) (conversion32.rs:56-60)."""
        mx = ((1 << (range_bits - 1)) - 1) / self.scale
        return (-mx, mx)

    def l2_clip_bound(self, range_bits: int) -> float:
        """(2^range - 1) ulp (conversion32.rs:62-64)."""
        return ((1 << range_bits) - 1) / self.scale

    # -- float → fixed bits -----------------------------------------------

    def f32_to_bits(self, values) -> np.ndarray:
        """|v| → saturating fixed-point bits (uint64), round-half-even
        (the `fixed` crate's from_float rounding)."""
        v = np.abs(np.asarray(values, dtype=np.float64))
        bits = np.rint(v * self.scale)  # rint = round half to even
        bits = np.clip(bits, 0, float(self.max_bits))
        return bits.astype(np.uint64)

    def f32_to_scalars(self, values) -> list[int]:
        """f32_to_scalar_vec: sign-magnitude scalars (Python ints mod l)."""
        values = np.asarray(values, dtype=np.float32)
        bits = self.f32_to_bits(values)
        out = []
        for v, b in zip(values, bits):
            s = int(b) % SS.L
            out.append(SS.L - s if (v < 0 and s != 0) else s)
        return out

    def f32_to_scalar_limbs(self, values) -> np.ndarray:
        """Vectorized: f32 array → (16, N) uint32 limb scalars (device input).

        Only limb0/limb1 carry magnitude bits (n_bits <= 32); negatives are
        l - mag, computed vectorized via precomputed l limbs.
        """
        values = np.asarray(values, dtype=np.float32)
        bits = self.f32_to_bits(values).astype(np.int64)
        n = len(values)
        out = np.zeros((16, n), dtype=np.uint32)
        neg = (values < 0) & (bits != 0)
        pos_idx = ~neg
        out[0, pos_idx] = (bits[pos_idx] & 0xFFFF).astype(np.uint32)
        out[1, pos_idx] = ((bits[pos_idx] >> 16) & 0xFFFF).astype(np.uint32)
        if neg.any():
            # l - mag, computed with borrow over the constant l limbs
            l_limbs = np.array(
                [(SS.L >> (16 * k)) & 0xFFFF for k in range(16)], dtype=np.int64
            )
            mags = np.stack([bits & 0xFFFF, (bits >> 16) & 0xFFFF], axis=0)
            borrow = np.zeros(n, dtype=np.int64)
            for k in range(16):
                m_k = mags[k] if k < 2 else 0
                d = l_limbs[k] - m_k - borrow
                borrow = (d < 0).astype(np.int64)
                d = d + (borrow << 16)
                out[k, neg] = d[neg].astype(np.uint32)
        return out

    # -- scalar → float ---------------------------------------------------

    def scalar_to_f32(self, s: int) -> float:
        s %= SS.L
        enc = SS.to_bytes(s)
        if enc[31] != 0:  # negative branch (conversion32.rs:24-28)
            mag_bytes = SS.to_bytes(SS.L - s)
            mag = int.from_bytes(mag_bytes[: (self.n_bits + 7) // 8], "little")
            mag &= self.max_bits
            return -(mag / self.scale)
        mag = int.from_bytes(enc[: (self.n_bits + 7) // 8], "little") & self.max_bits
        return mag / self.scale

    def scalars_to_f32(self, scalars) -> np.ndarray:
        return np.array([self.scalar_to_f32(s) for s in scalars], dtype=np.float32)

    def scalar_limbs_to_f32(self, limbs: np.ndarray) -> np.ndarray:
        """Vectorized decode of (16, N) canonical scalar limbs.

        Negative iff the top byte (high half of limb 15) is non-zero,
        matching scalar_to_f32's last-byte test (conversion32.rs:24).
        """
        limbs = np.asarray(limbs, dtype=np.int64)
        neg = (limbs[15] >> 8) != 0
        # magnitude for negatives: l - s over limbs (borrow chain)
        l_limbs = np.array(
            [(SS.L >> (16 * k)) & 0xFFFF for k in range(16)], dtype=np.int64
        )
        borrow = np.zeros(limbs.shape[1], dtype=np.int64)
        neg_mag = np.zeros(2, dtype=np.int64)
        mags = []
        for k in range(2):
            d = l_limbs[k] - limbs[k] - borrow
            borrow = (d < 0).astype(np.int64)
            mags.append(d + (borrow << 16))
        neg_mag = mags[0] | (mags[1] << 16)
        pos_mag = limbs[0] | (limbs[1] << 16)
        mag = np.where(neg, neg_mag, pos_mag) & self.max_bits
        return (np.where(neg, -mag, mag) / self.scale).astype(np.float32)

    # -- fixed-point square (conversion32.rs:66-89) -----------------------

    def square_scalar(self, s: int) -> int:
        """Fixed-point square with overflow panic semantics: interpret the
        scalar as signed fixed, square via (bits²) >> frac (the `fixed`
        crate truncates), fail if the result exceeds n_bits."""
        s %= SS.L
        enc = SS.to_bytes(s)
        if enc[31] != 0:
            mag = (SS.L - s) & self.max_bits
        else:
            mag = s & self.max_bits
        res = (mag * mag) >> self.n_frac
        if res > self.max_bits:
            raise OverflowError(
                f"fixed-point square overflow: {mag} (> {self.n_bits} bits)"
            )
        return res % SS.L


    # -- device codec -----------------------------------------------------

    def encode_device(self, values):
        """f32 tensor (N,) → (16, N) int32 scalar limbs on the tensor's
        device (same semantics as f32_to_scalar_limbs, without leaving the
        device)."""
        import torch

        v = torch.as_tensor(values)
        bits = torch.clamp(
            torch.round(torch.abs(v.to(torch.float64)) * self.scale), 0, float(self.max_bits)
        ).to(torch.int64)  # torch.round is round-half-to-even
        neg = (v < 0) & (bits != 0)
        n = v.shape[0]
        pos = torch.zeros((16, n), dtype=torch.int32, device=v.device)
        pos[0] = (bits & 0xFFFF).to(torch.int32)
        pos[1] = ((bits >> 16) & 0xFFFF).to(torch.int32)
        # l - mag with borrow chain
        neg_limbs = []
        borrow = torch.zeros(n, dtype=torch.int32, device=v.device)
        for k in range(16):
            l_k = (SS.L >> (16 * k)) & 0xFFFF
            d = (l_k + 0x10000) - pos[k] - borrow
            neg_limbs.append(d & 0xFFFF)
            borrow = 1 - (d >> 16)
        return torch.where(neg.unsqueeze(0), torch.stack(neg_limbs), pos)


DEFAULT_FP = FpConfig(16, 7)
