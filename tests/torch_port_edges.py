"""Edge inputs of the decompress kernel, shared by the host tests
(test_torch_csrc_host.py) and the tests on the card (test_torch_gpu.py).
Imports only the port's spec, so that it also runs where there is no JAX."""

from rofl_tpu_torch.spec import field as SF
from rofl_tpu_torch.spec import ristretto as SR

P = SF.P


def was_square(s: int) -> bool:
    """The square-root test of the decoding of s mod p (RFC 9496 4.3.1)."""
    ss = s * s % P
    u1, u2 = (1 - ss) % P, (1 + ss) % P
    u2_sqr = u2 * u2 % P
    v = (-SF.D * u1 % P * u1 - u2_sqr) % P
    return SF.sqrt_ratio_m1(1, v * u2_sqr % P)[0]


def decompress_edges(case: str, rng) -> list:
    """Values of s below 2^256 for one edge case of the decoding:
      special      s = 0, 1 and p - 1
      above_p      every s in [p, 2^255): p, p + 1, ..., 2^255 - 1
      bit_255      s with bit 255 set: 2^255, 2^255 + 1, 2^256 - 1, valid
                   encodings raised by p, and random ones
      odd          valid encodings with their low bit flipped (s < 0)
      non_squares  even s < p whose ratio is not square
      y_zero       the encodings whose y is 0: s^2 = 1 (s = 1, p - 1, p + 1)
                   and s^2 = -1 (s = +-sqrt(-1), and raised by p)
      valid        encodings of random points
    """
    good = [int.from_bytes(SR.hash_from_bytes_sha512(rng.bytes(16)).compress(), "little")
            for _ in range(8)]
    if case == "special":
        return [0, 1, P - 1]
    if case == "above_p":
        return list(range(P, 2**255))
    if case == "bit_255":
        raised = [s + P for s in good if s + P >= 2**255]
        rand = [int.from_bytes(rng.bytes(32), "little") | 1 << 255 for _ in range(8)]
        return [2**255, 2**255 + 1, 2**256 - 1] + raised + rand
    if case == "odd":
        return [s ^ 1 for s in good]
    if case == "non_squares":
        found = []
        while len(found) < 8:
            s = int.from_bytes(rng.bytes(32), "little") % P & ~1
            if not was_square(s):
                found.append(s)
        return found
    if case == "y_zero":
        return [1, P - 1, P + 1, SF.SQRT_M1, P - SF.SQRT_M1, SF.SQRT_M1 + P]
    return good


DECOMPRESS_EDGE_CASES = ("special", "above_p", "bit_255", "odd", "non_squares", "y_zero",
                         "valid")


def spec_decompress(s: int):
    """The spec's decoding of s mod p: the point, or None where the mask must
    be false. The raw bytes' check s < p is the caller's, so s and s + p
    decode alike here."""
    return SR.decompress(SF.to_bytes(s % P))
