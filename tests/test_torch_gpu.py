"""The CUDA kernels against their plain torch versions, on the card; the
launch counts under threads; and FL rounds (Plain, EncRange, and EncRange
with lazy verification, honest and tampered) at d = 64 with the crypto on
the card, over the port's transport.

Needs an NVIDIA GPU and nvcc, so every test carries the ``gpu`` marker and the
CPU command deselects them with ``-m "not gpu"``; the fixture's skip only
guards a run that selects them without a card. On the card:

    python -m pytest tests/test_torch_gpu.py -m gpu -q

``chip_smoke.py`` makes the same comparison at the full width of the round."""

import sys
import threading

import numpy as np
import pytest
import torch

from rofl_tpu_torch.crypto import pedersen
from rofl_tpu_torch.fl import params as P
from rofl_tpu_torch.fl import wire
from rofl_tpu_torch.fl.server import ServerConfig
from rofl_tpu_torch.ops import curve, fe, kernels, sc
from rofl_tpu_torch.spec import ristretto as SR
from rofl_tpu_torch.spec import field as SF
from rofl_tpu_torch.spec import scalar as SS
from torch_port_edges import DECOMPRESS_EDGE_CASES, decompress_edges, spec_decompress
from torch_port_fl import cancelling_fns, run_fl

pytestmark = pytest.mark.gpu


def lowest_digits(c):
    """The scalar whose signed c-bit digits below the top one are all
    -2^(c-1): 2^256 less the recoding's offset (all -8 at c = 4)."""
    return 2**256 - sum((1 << (c - 1)) << (c * i) for i in range(-(-257 // c) - 1))


def ladder_scalars(n, rng):
    """0, 1, l-1 in the first six lanes, then 2^256-1 and the scalars whose
    digits are all the lowest at c = 4 (the ladder) and c = 3, then random
    canonical scalars."""
    edges = [2**256 - 1, lowest_digits(4), lowest_digits(3)]
    return [[0, 1, SS.L - 1][i % 3] if i < 6 else edges[i - 6] if i < 9
            else int.from_bytes(rng.bytes(32), "little") % SS.L for i in range(n)]


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    kernels.build_kernels()
    return "cuda"


def operands(n, device, seed):
    rng = np.random.default_rng(seed)
    pool = [SR.hash_from_bytes_sha512(rng.bytes(16)) for _ in range(8)]
    pool += [SR.identity(), SR.BASEPOINT, -SR.BASEPOINT]
    packed = curve.pack_points(pool, device)
    i = torch.from_numpy(rng.integers(0, len(pool), size=n)).to(device)
    j = torch.from_numpy(rng.integers(0, len(pool), size=n)).to(device)
    scale = fe.to_tensor(rng.integers(1, 1 << 16, size=(16, n)), device)
    p = tuple(fe.mul(c[:, i], scale) for c in packed)
    q = tuple(c[:, j].contiguous() for c in packed)
    return p, q


def canonical_equal(got, want):
    return all(torch.equal(fe.canonicalize(a), fe.canonicalize(b.expand_as(a)))
               for a, b in zip(got, want))


@pytest.mark.parametrize("n", [1, 77, 1000])
def test_kernels_equal_their_plain_versions(card, n):
    p, q = operands(n, card, seed=n)
    before, lanes_before = dict(kernels.LAUNCHES), dict(kernels.LANES)
    assert canonical_equal(kernels.point_add(p, q), kernels.point_add_ref(p, q))
    q1 = tuple(c[:, :1].contiguous() for c in q)
    assert canonical_equal(kernels.point_add(p, q1), kernels.point_add_ref(p, q1))
    assert canonical_equal(kernels.point_double(p), kernels.point_double_ref(p))
    enc = kernels.compress(p)
    assert torch.equal(enc, kernels.compress_ref(p))
    enc[0, ::3] ^= 1  # every third encoding gets an odd s: invalid
    (k_pt, k_valid), (r_pt, r_valid) = kernels.decompress(enc), kernels.decompress_ref(enc)
    assert canonical_equal(k_pt, r_pt) and torch.equal(k_valid, r_valid)
    wide = torch.from_numpy(
        np.random.default_rng(n).integers(0, 256, size=(64, n)).astype(np.int32)).to(card)
    wide[:, 0] = 255  # 2^512 - 1
    assert torch.equal(kernels.sc_reduce_wide(wide), kernels.sc_reduce_wide_ref(wide))
    torch.cuda.synchronize()
    a = kernels.sc_reduce_wide(wide)
    b = torch.flip(a, dims=(1,)).contiguous()
    edges = fe.to_tensor(sc.pack_scalars([0, 1, SS.L - 1, 1 << 252]), card)
    a[:, :min(n, 4)] = edges[:, :min(n, 4)]
    b1 = b[:, :1].contiguous()
    for name in ("sc_mul", "sc_add", "sc_sub"):
        kernel_fn, plain_fn = getattr(kernels, name), getattr(kernels, name + "_ref")
        assert torch.equal(kernel_fn(a, b), plain_fn(a, b))
        assert torch.equal(kernel_fn(a, b1), plain_fn(a, b1))
    torch.cuda.synchronize()
    launches = {"point_add": 2, "point_double": 1, "compress": 1, "decompress": 1,
                "sc_reduce_wide": 2, "sc_mul": 2, "sc_add": 2, "sc_sub": 2, "scalar_mul": 0,
                "msm_flat": 0, "msm_groups": 0, "shared_scalar_mul": 0, "scalar_mul_window": 0,
                "point_sum": 0, "sc_sum": 0}
    assert {k: kernels.LAUNCHES[k] - before[k] for k in before} == launches
    assert {k: kernels.LANES[k] - lanes_before[k] for k in lanes_before} == {
        k: v * n for k, v in launches.items()}


@pytest.mark.parametrize("case", DECOMPRESS_EDGE_CASES)
def test_decompress_kernel_on_edges(card, case):
    """decompress on the host tests' edge values of s below 2^256
    (torch_port_edges.decompress_edges), alone and tiled to 77 lanes: mask
    and canonical coordinates equal to the plain version's, z as canonical
    1, and the mask equal to the spec's decoding of s mod p."""
    values = decompress_edges(case, np.random.default_rng(len(case)))
    for lanes in (values, [values[i % len(values)] for i in range(77)]):
        s = fe.to_tensor(fe.pack_scalars(lanes), card)
        (k_pt, k_valid), (r_pt, r_valid) = kernels.decompress(s), kernels.decompress_ref(s)
        assert canonical_equal(k_pt, r_pt) and torch.equal(k_valid, r_valid)
        assert torch.equal(k_pt[2], fe.ones((len(lanes),), card))
        assert k_valid.cpu().tolist() == [spec_decompress(v) is not None for v in lanes]


def weakly_reduced(coords):
    """Each value of (16, n) limbs raised by the largest multiple of p that
    keeps it below 2^256."""
    return tuple(fe.to_tensor(fe.pack_scalars(
        [v + (2**256 - 1 - v) // SF.P * SF.P for v in fe.unpack_scalars(c)]), c.device)
        for c in coords)


@pytest.mark.parametrize("case", ["identity_forms", "weakly_reduced", "point_add_outputs",
                                  "scalar_mul_outputs", "msm_outputs"])
@pytest.mark.parametrize("n", [1, 77])
def test_point_double_kernel_on_edges(card, case, n):
    """point_double against its plain version and the spec on the identity
    as (0 : s : s : 0) (every limb 2^16 - 1 among them), on coordinates
    raised into [p, 2^256), and on what the 32-bit point_add, scalar_mul and
    msm_groups leave."""
    rng = np.random.default_rng(n)
    p, q = operands(n, card, seed=n + 1)
    pts = curve.unpack_points(curve.PointArray(*p))
    if case == "identity_forms":
        s = [[1, 2**256 - 1, SF.P + 1, 2**255][i % 4] for i in range(n)]
        x = tuple(fe.to_tensor(fe.pack_scalars(v), card) for v in ([0] * n, s, s, [0] * n))
        pts = [SR.identity()] * n
    elif case == "weakly_reduced":
        x = weakly_reduced(p)
    elif case == "point_add_outputs":
        x = kernels.point_add(p, q)
        pts = [a + b for a, b in zip(pts, curve.unpack_points(curve.PointArray(*q)))]
    elif case == "scalar_mul_outputs":
        ks = ladder_scalars(n, rng)
        x = kernels.scalar_mul(fe.to_tensor(fe.pack_scalars(ks), card), p)
        pts = [a.scalar_mul(k % SS.L) for a, k in zip(pts, ks)]
    else:
        group = 1 if n == 1 else 7
        ks = ladder_scalars(n // group * group, rng)
        pp = tuple(c[:, :len(ks)].contiguous() for c in p)
        x = kernels.msm_groups(fe.to_tensor(fe.pack_scalars(ks), card), pp, group)
        sums = []
        for g in range(0, len(ks), group):
            acc = SR.identity()
            for a, k in zip(pts[g:g + group], ks[g:g + group]):
                acc = acc + a.scalar_mul(k % SS.L)
            sums.append(acc)
        pts = sums
    got = kernels.point_double(x)
    assert canonical_equal(got, kernels.point_double_ref(x))
    assert [bytes(r) for r in curve.compress_to_bytes(curve.PointArray(*got))] == [
        a.double().compress() for a in pts]


@pytest.mark.parametrize("n", [1, 6, 77, 200])
def test_scalar_mul_kernel_equals_its_plain_version_and_the_spec(card, n):
    """k = 0, 1, l-1, 2^256-1 and the all -8 scalar among random ones, the
    identity and the basepoint among the points, one broadcast scalar (the
    all -8 one where there is one); lane counts that leave the last block
    of 64 threads part empty."""
    rng = np.random.default_rng(n)
    pool = [SR.hash_from_bytes_sha512(rng.bytes(16)) for _ in range(3)]
    pool += [SR.identity(), SR.BASEPOINT]
    pts = [pool[i % len(pool)] for i in range(n)]
    ks = ladder_scalars(n, rng)
    p = tuple(curve.pack_points(pts, card))
    k = fe.to_tensor(fe.pack_scalars(ks), card)  # not reduced mod l
    b = min(7, n - 1)
    before = kernels.LAUNCHES["scalar_mul"]
    got = kernels.scalar_mul(k, p)
    one = kernels.scalar_mul(k[:, b:b + 1].contiguous(), p)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["scalar_mul"] - before == 2
    assert torch.equal(kernels.compress(got), kernels.compress(kernels.scalar_mul_ref(k, p)))
    assert [bytes(r) for r in curve.compress_to_bytes(curve.PointArray(*got))] == [
        q.scalar_mul(v % SS.L).compress() for q, v in zip(pts, ks)]
    assert [bytes(r) for r in curve.compress_to_bytes(curve.PointArray(*one))] == [
        q.scalar_mul(ks[b] % SS.L).compress() for q in pts]


def test_scalar_sums_on_the_card_take_any_length(card):
    values = [SS.L - 1, 1, 1 << 252] + list(range(12))
    limbs = fe.to_tensor(sc.pack_scalars(values), card)
    before = dict(kernels.LAUNCHES)
    assert sc.unpack_scalars(sc.sum_reduce(limbs)) == [sum(values) % SS.L]
    # one sc_sum launch, no chain of sc_add
    assert kernels.LAUNCHES["sc_sum"] - before["sc_sum"] == 1
    assert kernels.LAUNCHES["sc_add"] == before["sc_add"]
    assert sc.unpack_scalars(sc.sum_reduce_groups(limbs, 5)) == [
        sum(values[g:g + 5]) % SS.L for g in (0, 5, 10)]
    assert sc.unpack_scalars(sc.neg(limbs)) == [(-v) % SS.L for v in values]
    assert sc.unpack_scalars(sc.sum_reduce(limbs[:, :2])) == [0]


# The sums' layouts on the paths: tree_sum of d, the provers' A sums, the
# IPA's groups, the clients' column sums, the verifier's chunk-axis sums,
# and a ragged length.
SUM_LAYOUTS = [(1, 50000, 1), (16, 32768, 1), (32, 1, 1), (32, 2, 1), (32, 3, 1), (32, 77, 1),
               (32, 16384, 1), (1, 4, 50000), (1, 16, 32768), (1, 100001, 1)]


def sum_operands(n, device, seed):
    """n points from ``operands`` and n canonical scalars, l - 1 and 0 among
    them."""
    p, _ = operands(n, device, seed)
    wide = torch.from_numpy(
        np.random.default_rng(seed).integers(0, 256, size=(64, n)).astype(np.int32)).to(device)
    wide[:, 0] = 0
    a = kernels.sc_reduce_wide(wide)
    a[:, -1] = fe.to_tensor(sc.pack_scalars([SS.L - 1]), device)[:, 0]
    return p, a


@pytest.mark.parametrize("layout", SUM_LAYOUTS)
def test_sum_kernels_equal_their_plain_versions(card, layout):
    """point_sum and sc_sum against their plain halving chains at the paths'
    layouts: scalars bit-equal, points as canonical encodings (the kernel
    adds in another order); one launch each (none for R = 1) and N lanes."""
    outer, r, inner = layout
    n = outer * r * inner
    p, a = sum_operands(n, card, seed=n)
    before, lanes_before = dict(kernels.LAUNCHES), dict(kernels.LANES)
    got_a = kernels.sc_sum(a, outer, r, inner)
    got_p = kernels.point_sum(p, outer, r, inner)
    torch.cuda.synchronize()
    counted = {k: kernels.LAUNCHES[k] - before[k] for k in before if kernels.LAUNCHES[k] != before[k]}
    assert counted == ({} if r == 1 else {"sc_sum": 1, "point_sum": 1})
    if r > 1:
        assert kernels.LANES["sc_sum"] - lanes_before["sc_sum"] == n
        assert kernels.LANES["point_sum"] - lanes_before["point_sum"] == n
    assert got_a.shape == (16, outer * inner)
    assert torch.equal(got_a, kernels.sc_sum_ref(a, outer, r, inner))
    want_p = kernels.point_sum_ref(p, outer, r, inner)
    assert torch.equal(kernels.compress(got_p), kernels.compress(want_p))


def test_sum_wrappers_refuse_what_the_kernels_do_not_take(card):
    p, a = sum_operands(12, card, seed=12)
    for bad in (a.to(torch.int64), a[:8].contiguous(), a[:, ::2]):
        with pytest.raises(ValueError):
            kernels.sc_sum(bad, 1, bad.shape[1], 1)
    with pytest.raises(ValueError):
        kernels.sc_sum(a, 1, 5, 1)  # 12 lanes are not 1 x 5 x 1
    with pytest.raises(ValueError):
        kernels.point_sum((p[0], p[1].cpu()) + p[2:], 3, 4, 1)  # coordinates on two devices
    with pytest.raises(ValueError):
        kernels.point_sum(tuple(c.to(torch.int64) for c in p), 3, 4, 1)
    with pytest.raises(ValueError):
        kernels.point_sum(p, 0, 12, 1)
    for group in (0, 5):
        with pytest.raises(ValueError):
            sc.sum_reduce_groups(a, group)
        with pytest.raises(ValueError):
            curve.tree_sum_groups(curve.PointArray(*p), group)


def test_wrappers_refuse_what_the_kernels_do_not_take(card):
    p, q = operands(8, card, seed=3)
    with pytest.raises(ValueError):
        kernels.point_add(p, tuple(c[:, :5].contiguous() for c in q))
    with pytest.raises(ValueError):
        kernels.point_double(tuple(c.to(torch.int64) for c in p))
    with pytest.raises(ValueError):
        kernels.compress(tuple(c[:, ::2] for c in p))
    with pytest.raises(ValueError):
        kernels.decompress(p[0].cpu().to(card)[:8])
    with pytest.raises(ValueError):
        kernels.sc_reduce_wide(torch.zeros((32, 8), dtype=torch.int32, device=card))
    a = torch.zeros((16, 8), dtype=torch.int32, device=card)
    for wrapper in (kernels.sc_mul, kernels.sc_add, kernels.sc_sub):
        with pytest.raises(ValueError):
            wrapper(a, a[:, :5].contiguous())  # neither n nor 1 lanes
        with pytest.raises(ValueError):
            wrapper(a, a.to(torch.int64))
        with pytest.raises(ValueError):
            wrapper(a[:, ::2], a[:, ::2])  # not contiguous
    with pytest.raises(ValueError):
        kernels.scalar_mul(a[:, :3].contiguous(), p)
    with pytest.raises(ValueError):
        kernels.scalar_mul(a, tuple(c[:, :1].contiguous() for c in p))  # P does not broadcast
    with pytest.raises(ValueError):
        kernels.scalar_mul(a.cpu(), p)


@pytest.mark.parametrize("n,group", [
    (1, 1), (77, 77), (32, 2), (130, 65), (300, 100), (1000, 1000), (2 * 24593, 24593)])
def test_msm_kernel_equals_its_plain_version_and_the_spec(card, n, group):
    """msm_groups (and msm_flat where there is one group) against the plain
    version and the spec, as canonical encodings: zero scalars, l-1,
    2^256-1 and the all -8 scalar, the identity among the points, and one
    broadcast scalar. Groups of the prime 24593 terms are cut into slices
    by the wrapper, which then cannot divide them."""
    rng = np.random.default_rng(n)
    pool = [SR.hash_from_bytes_sha512(rng.bytes(16)) for _ in range(3)]
    pool += [SR.identity(), SR.BASEPOINT]
    pts = [pool[i % len(pool)] for i in range(n)]
    ks = ladder_scalars(n, rng)
    p = tuple(curve.pack_points(pts, card))
    k = fe.to_tensor(fe.pack_scalars(ks), card)  # not reduced mod l
    slices = kernels.msm_slices(n // group, group, kernels.MSM_DIGITS,
                                kernels.msm_blocks_per_wave(card))
    assert slices > 1 if group == 24593 else slices == 1
    before = dict(kernels.LAUNCHES)
    got = kernels.msm_groups(k, p, group)
    one = kernels.msm_groups(k[:, -1:].contiguous(), p, group)
    flat = kernels.msm_flat(k, p)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["msm_groups"] - before["msm_groups"] == 2
    assert kernels.LAUNCHES["msm_flat"] - before["msm_flat"] == 1
    assert torch.equal(kernels.compress(got), kernels.compress(kernels.msm_groups_ref(k, p, group)))

    def spec_sums(scalars, size):
        """Each group's sum, as sum_j (sum of its k_i with P_i = pool[j]) pool[j]."""
        sums = []
        for g in range(0, n, size):
            per_point = [0] * len(pool)
            for i in range(g, g + size):
                per_point[i % len(pool)] += scalars[i]
            acc = SR.identity()
            for q, v in zip(pool, per_point):
                acc = acc + q.scalar_mul(v % SS.L)
            sums.append(acc.compress())
        return sums

    encode = lambda out: [bytes(r) for r in curve.compress_to_bytes(curve.PointArray(*out))]
    assert encode(got) == spec_sums(ks, group)
    assert encode(one) == spec_sums([ks[-1]] * n, group)
    assert encode(flat) == spec_sums(ks, n)


def test_msm_wrappers_refuse_what_the_kernel_does_not_take(card):
    p, _ = operands(8, card, seed=4)
    a = torch.zeros((16, 8), dtype=torch.int32, device=card)
    for call in (lambda k, q: kernels.msm_flat(k, q), lambda k, q: kernels.msm_groups(k, q, 4)):
        with pytest.raises(ValueError):
            call(a[:, :3].contiguous(), p)  # neither n nor 1 scalars
        with pytest.raises(ValueError):
            call(a.to(torch.int64), p)
        with pytest.raises(ValueError):
            call(a, tuple(c[:, ::2] for c in operands(16, card, seed=5)[0]))  # not contiguous
        with pytest.raises(ValueError):
            call(a.cpu(), p)
    with pytest.raises(ValueError):
        kernels.msm_groups(a, p, 3)  # 3 does not divide 8


@pytest.mark.parametrize("k", [0, 1, 2, SS.L - 1, (1 << 200) | 5, 2**253 - 1, 2**256 - 1])
def test_shared_scalar_mul_kernel_equals_its_plain_version_and_the_spec(card, k):
    rng = np.random.default_rng(k % 1000)
    pool = [SR.hash_from_bytes_sha512(rng.bytes(16)) for _ in range(3)]
    pool += [SR.identity(), SR.BASEPOINT]
    pts = [pool[i % len(pool)] for i in range(77)]
    p = tuple(curve.pack_points(pts, card))
    limbs = fe.to_tensor(sc.pack_scalars([k]), card)
    before = kernels.LAUNCHES["shared_scalar_mul"]
    got = kernels.shared_scalar_mul(limbs, p)
    host = kernels.shared_scalar_mul(sc.pack_scalars([k]).reshape(16), p)  # host limbs too
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["shared_scalar_mul"] - before == 2
    want = kernels.compress(kernels.shared_scalar_mul_ref(limbs, p))
    assert torch.equal(kernels.compress(got), want) and torch.equal(kernels.compress(host), want)
    assert [bytes(r) for r in curve.compress_to_bytes(curve.PointArray(*got))] == [
        q.scalar_mul(k % SS.L).compress() for q in pts]


@pytest.mark.parametrize("window", kernels.WINDOWS)
@pytest.mark.parametrize("n", [1, 6, 77])
def test_scalar_mul_window_kernel_equals_its_plain_version_and_the_spec(card, window, n):
    rng = np.random.default_rng(window * 100 + n)
    pool = [SR.hash_from_bytes_sha512(rng.bytes(16)) for _ in range(3)]
    pool += [SR.identity(), SR.BASEPOINT]
    pts = [pool[i % len(pool)] for i in range(n)]
    ks = [[0, 1, SS.L - 1][i % 3] if i < 6 else int.from_bytes(rng.bytes(32), "little") % SS.L
          for i in range(n)]
    p = tuple(curve.pack_points(pts, card))
    k = fe.to_tensor(sc.pack_scalars(ks), card)
    before = kernels.LAUNCHES["scalar_mul_window"]
    got = kernels.scalar_mul_window(k, p, window)
    one = kernels.scalar_mul_window(k[:, -1:].contiguous(), p, window)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["scalar_mul_window"] - before == 2
    assert torch.equal(kernels.compress(got),
                       kernels.compress(kernels.scalar_mul_window_ref(k, p, window)))
    assert torch.equal(kernels.compress(got), kernels.compress(kernels.scalar_mul(k, p)))
    assert [bytes(r) for r in curve.compress_to_bytes(curve.PointArray(*got))] == [
        q.scalar_mul(v).compress() for q, v in zip(pts, ks)]
    assert [bytes(r) for r in curve.compress_to_bytes(curve.PointArray(*one))] == [
        q.scalar_mul(ks[-1]).compress() for q in pts]


def test_new_ladder_wrappers_refuse_what_the_kernels_do_not_take(card):
    p, _ = operands(8, card, seed=6)
    k = torch.zeros((16, 8), dtype=torch.int32, device=card)
    for window in (1, 3, 8):
        with pytest.raises(ValueError):
            kernels.scalar_mul_window(k, p, window)
    with pytest.raises(ValueError):
        kernels.scalar_mul_window(k[:, :3].contiguous(), p, 4)  # neither n nor 1 scalars
    with pytest.raises(ValueError):
        kernels.scalar_mul_window(k.cpu(), p, 2)
    with pytest.raises(ValueError):
        kernels.shared_scalar_mul(k, p)  # eight scalars, not one
    with pytest.raises(ValueError):
        kernels.shared_scalar_mul(k[:, :1], tuple(c[:, ::2] for c in operands(16, card, 7)[0]))


def test_launch_counts_lose_no_update_across_threads(card):
    """Eight threads launch sc_add at once, with a short switch interval:
    every launch and every lane is counted."""
    a = fe.to_tensor(sc.pack_scalars(list(range(33))), card)
    before, lanes_before = kernels.LAUNCHES["sc_add"], kernels.LANES["sc_add"]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [kernels.sc_add(a, a) for _ in range(200)])
                   for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["sc_add"] - before == 8 * 200
    assert kernels.LANES["sc_add"] - lanes_before == 8 * 200 * 33


@pytest.mark.parametrize("enc_type", [P.PLAIN_TYPE, P.ENC_RANGE_TYPE])
def test_fl_round_on_the_card(card, enc_type):
    """One round of 3 DummyTrainer clients at d = 64 over the transport, the
    crypto on the card: Plain gives 0.001, EncRange (cancelling blindings,
    0.001 rounds to 0) the accumulator's one unit, 1/128 / 3."""
    d, n = 64, 3
    cfg = ServerConfig(num_clients=n, num_params=d, num_rounds=1, enc_type=enc_type,
                       crypto=P.CryptoConfig(value_range=8, n_partition=1, enc_type=enc_type),
                       write_model_file=False, bench_dir=None, device=card)
    rng = np.random.default_rng(64 + enc_type)
    fns = cancelling_fns({0: pedersen.cancelling_scalar_limbs(n, d, rng, card)})
    before = dict(kernels.LAUNCHES)
    state, clients = run_fl(cfg, n, blinding_fns=fns, timeout=300)
    assert state.status == "done"
    assert [c.done_status for c in clients] == [wire.STATUS_DONE] * n
    if enc_type == P.PLAIN_TYPE:
        np.testing.assert_allclose(state.global_model, np.full(d, 0.001, np.float32), atol=1e-6)
    else:
        np.testing.assert_array_equal(state.rounds[0].extracted, np.full(d, 1 / 128, np.float32))
        np.testing.assert_allclose(state.global_model, np.full(d, np.float32(1 / 128) / n,
                                                               np.float32), atol=1e-6)
        for name in ("point_add", "compress", "decompress", "scalar_mul", "msm_flat",
                     "msm_groups", "sc_mul"):
            assert kernels.LAUNCHES[name] > before[name], name


@pytest.mark.parametrize("tamper_round", [None, 0, 1])
def test_lazy_verification_on_the_card(card, tamper_round):
    """Lazy verification, EncRange at d = 64, 3 DummyTrainer clients, 3
    rounds: honest, every round is applied and the run ends done; with
    client 1's rand proof flipped in round r, rounds up to r are applied and
    the run fails at round r + 1's finalize, which waits for round r's
    verification (rofl_tpu/fl/server.py:234-240)."""
    d, n, rounds = 64, 3, 3
    cfg = ServerConfig(num_clients=n, num_params=d, num_rounds=rounds, enc_type=P.ENC_RANGE_TYPE,
                       crypto=P.CryptoConfig(value_range=8, n_partition=1,
                                             enc_type=P.ENC_RANGE_TYPE),
                       lazy_verification=True, write_model_file=False, bench_dir=None,
                       device=card)
    rng = np.random.default_rng(640)
    fns = cancelling_fns({r: pedersen.cancelling_scalar_limbs(n, d, rng, card)
                          for r in range(rounds)})
    state, _ = run_fl(cfg, n, blinding_fns=fns, timeout=300,
                      tampered=() if tamper_round is None else (1,), tamper_round=tamper_round)
    applied = rounds if tamper_round is None else tamper_round + 1
    want = np.zeros(d, np.float32)
    for _ in range(applied):  # 0.001 rounds to 0 units: each sum is the one unit
        want = want + np.full(d, 1 / 128, np.float32) * (1.0 / n) * 1.0
    np.testing.assert_array_equal(state.global_model, want)
    finished = sorted(s.round_id for s in state.rounds if s.is_done())
    if tamper_round is None:
        assert state.status == "done" and finished[-1] == rounds - 1
    else:
        assert state.status == "failed"
        assert finished[-1] == tamper_round
        assert any(s.round_id == tamper_round + 1 and s.extracted is not None
                   for s in state.rounds)


def test_jax_random_on_the_card_is_the_cpus(card):
    """The port's threefry bits and uniforms on the card equal the CPU's, bit
    for bit (the CPU tests hold those to ``jax.random``), tiles included;
    its normals and a block of P agree within 4 float32 ulps."""
    from rofl_tpu_torch.models import intrinsic
    from rofl_tpu_torch.models import jax_random as R

    key = R.fold_in(R.PRNGKey(21), 3)
    for shape, start in (((7,), 0), ((129, 33), 0), ((40, 5000), 1234 * 5000)):
        assert torch.equal(R.bits(key, shape, card, start).cpu(), R.bits(key, shape, "cpu", start))
        assert torch.equal(R.uniform(key, shape, -0.3, 2.0, card, start).cpu(),
                           R.uniform(key, shape, -0.3, 2.0, "cpu", start))
    got = R.normal(key, (300_000,), card).cpu().numpy()
    want = R.normal(key, (300_000,), "cpu").numpy()
    assert np.max(np.abs(got - want) / np.spacing(np.abs(want))) <= 4
    (_, p_card), = list(intrinsic.projection_tiles(64, 1000, 2, card))
    (_, p_cpu), = list(intrinsic.projection_tiles(64, 1000, 2, "cpu"))
    assert np.max(np.abs(p_card.cpu().numpy() - p_cpu.numpy())
                  / np.spacing(np.abs(p_cpu.numpy()))) <= 4


def test_sharded_msm_on_a_virtual_mesh_of_the_card(card):
    """sharded_msm over cuda:0 four times (300 000 terms split evenly) and
    three times (50 001 terms: two identity terms of padding) equals msm.msm,
    encoding for encoding, and launches one msm_flat a shard and one
    point_sum for the partials."""
    from rofl_tpu_torch.ops import msm
    from rofl_tpu_torch.parallel import mesh as pmesh

    rng = np.random.default_rng(14)
    for n, shards in ((300_000, 4), (50_001, 3)):
        ks = pedersen.rnd_scalar_tensor(n, rng, card)
        pts = pedersen.base_B().mul(pedersen.rnd_scalar_tensor(n, rng, card))
        mesh = pmesh.param_mesh(shards, [torch.device("cuda", 0)] * shards)
        before = dict(kernels.LAUNCHES)
        got = pmesh.sharded_msm(mesh, pts, ks)
        assert kernels.LAUNCHES["msm_flat"] - before["msm_flat"] == shards
        assert kernels.LAUNCHES["point_sum"] - before["point_sum"] == 1
        assert got.x.device == torch.device("cuda", 0) and got.x.shape == (16, 1)
        assert (curve.compress_to_bytes(got) == curve.compress_to_bytes(msm.msm(pts, ks))).all()


def test_l2_verify_with_a_virtual_mesh_of_the_card(card):
    """EncParamsL2 at d = 4096, 16 partitions: verify with a mesh of cuda:0
    four times accepts the honest update (its range proofs' combined MSM
    sharded) and refuses one with a flipped range-proof bit; the range proofs
    made with the mesh are the unsharded ones, byte for byte."""
    from rofl_tpu_torch.crypto import range_proof as RP
    from rofl_tpu_torch.crypto import range_proof_vec as RPV
    from rofl_tpu_torch.crypto.fp_codec import FpConfig
    from rofl_tpu_torch.parallel import mesh as pmesh

    d, fp = 4096, FpConfig(16, 7)
    cfg = P.CryptoConfig(value_range=8, n_partition=16, l2_value_range=16, fp=fp,
                         enc_type=P.ENC_L2_TYPE)
    rng = np.random.default_rng(15)
    vals = rng.uniform(-0.01, 0.01, d).astype(np.float32)
    blind = pedersen.rnd_scalar_tensor(d, rng, card)
    mesh = pmesh.param_mesh(4, [torch.device("cuda", 0)] * 4)
    enc = P.EncParamsL2.encrypt(vals, blind, cfg, rng, card)
    dec = P.EncParamsL2.deserialize(enc.serialize(), fp, card)
    before = dict(kernels.LAUNCHES)
    assert dec.verify(rng, mesh)
    assert kernels.LAUNCHES["msm_flat"] - before["msm_flat"] >= 4
    raw = bytearray(dec.range_proofs[5].to_bytes())
    raw[5 * 32] ^= 1
    bad = P.EncParamsL2(dec.enc_values, dec.square_proofs,
                        dec.range_proofs[:5] + [RP.RangeProof.from_bytes(bytes(raw))]
                        + dec.range_proofs[6:], dec.square_range_proof, dec.prove_range,
                        dec.l2_prove_range, fp)
    assert not bad.verify(rng, mesh)
    clipped = RPV.clip_f32_to_range_vec(vals, fp, 8)
    plain, _ = RPV.create_rangeproof(clipped, blind, fp, 8, 16, np.random.default_rng(3), card)
    sharded, _ = RPV.create_rangeproof(clipped, blind, fp, 8, 16, np.random.default_rng(3),
                                       card, mesh)
    assert [p.to_bytes() for p in plain] == [p.to_bytes() for p in sharded]
