"""Device mesh for the secure-aggregation data plane.

Counterpart of ``rofl_tpu.parallel.mesh``, with its names. Axes:

  'client' — data-parallel across FL clients (each client's commitments and
             proofs on its row of the mesh)
  'param'  — the parameter-vector dimension d: commitments, Σ-protocol
             lanes, MSM terms and BSGS walks shard over lanes of this axis
             (the reference chunks with rayon + n_partition,
             range_proof_vec/mod.rs:53-78)

The JAX mesh is single-controller SPMD: one process places shards on a grid
of devices. So is this one: a ``Mesh`` is a 2-D grid of ``torch.device``s,
and one process runs each shard's work on that shard's device, under
``torch.cuda.device(d)`` on its current stream (the kernel wrappers take the
device from the tensor). A device may repeat in the grid, which gives a
virtual mesh: ``cuda:0`` four times on one card, ``cpu`` eight times in the
tests, as the JAX tests force 8 host devices. With several cards the same
code takes ``cuda:0..n-1``. That is unmeasured: for the paths that only
launch (``sharded_msm``, ``sharded_msm_grouped``) the shards are expected to
overlap on their cards, as launches are asynchronous; ``lane_map`` over the
Σ cores reads each shard's per-lane transcript back to the host before the
next shard's launches are issued, so those shards would still run one after
another.

The crypto is elementwise over (16, N) lanes, so sharding N over 'param'
partitions it; the only cross-device step is the REDUCTION of ``sharded_msm``:
point addition is a group operation, not a sum of numbers, so each shard's
single-point partial is copied to the mesh's first device (bytes, not the
sharded vectors) and the partials are summed there (``point_sum``). Results
land on the mesh's first device, where the caller's host transcript reads
them, as the JAX package replicates them. Lane counts that do not divide the
axis are padded with inert lanes, identity points (0, 1, 1, 0) and zero
scalars, which are sliced off again on the way out.

Not carried: ``shard_map``, ``NamedSharding``, the ``check_vma`` /
``check_rep`` shim, and the ``jax.jit`` wrappers with their ``lru_cache``s
of compiled functions (there is nothing to compile). The tables a shard
needs (fixed-base, BSGS, Bulletproof generators) come from the port's
caches, which are keyed by device, so a virtual mesh builds each once.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import torch

from ..ops import bsgs, curve, fe, fixed_base, msm as msm_mod
from ..ops.curve import PointArray

AXES = ("client", "param")


class Mesh:
    """A 2-D grid of devices on the axes ("client", "param"); ``shape`` maps
    each axis to its size, as the JAX ``Mesh`` does."""

    axis_names = AXES

    def __init__(self, grid):
        self.devices = [[fe.canonical_device(d) for d in row] for row in grid]
        if not self.devices or not self.devices[0] or len(
                {len(row) for row in self.devices}) != 1:
            raise ValueError("a mesh is a non-empty rectangular grid of devices")
        self.shape = {"client": len(self.devices), "param": len(self.devices[0])}

    @property
    def first(self) -> torch.device:
        """The device that reduced and grouped results land on."""
        return self.devices[0][0]

    def param_devices(self) -> list:
        """The 'param' axis of the first client row."""
        return self.devices[0]

    def client_row(self, c: int) -> "Mesh":
        """Client c's row as a 1 × n_param mesh."""
        return Mesh([self.devices[c]])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {self.devices})"


def resolve_devices(devices) -> list:
    """`devices` as torch devices; None means every card."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def make_mesh(n_client: int, n_param: int, devices=None) -> Mesh:
    """An n_client × n_param mesh over the first devices of `devices` (every
    card when None; a device may repeat)."""
    devices = resolve_devices(devices)
    assert len(devices) >= n_client * n_param, "not enough devices"
    return Mesh([devices[c * n_param:(c + 1) * n_param] for c in range(n_client)])


def param_mesh(n_param: int | None = None, devices=None) -> Mesh:
    """1×N mesh with only the 'param' axis (pure d-sharding)."""
    devices = resolve_devices(devices)
    return make_mesh(1, n_param or len(devices), devices)


# -- lanes: padding, shards, gathers ------------------------------------------


class Sharded(NamedTuple):
    """A lane operand split over the 'param' axis: its shards, each on its
    device, and the true lane count (the padding is not part of it)."""

    shards: list
    n: int


def _on_device(device: torch.device):
    """The context in which a shard's launches go to `device`'s current
    stream."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def _rebuild(like: tuple, items: list) -> tuple:
    return type(like)(*items) if hasattr(like, "_fields") else tuple(items)


def _lanes(x) -> int:
    if isinstance(x, tuple):
        return _lanes(x[0])
    return x.shape[-1]


def _pad(x, pad: int):
    """Pad the lane axis with inert lanes: identity points, zero scalars."""
    if not pad:
        return x
    if isinstance(x, PointArray):
        ident = curve.identity((pad,), x.device)
        return PointArray(*[torch.cat([c, i.expand(fe.NLIMB, pad)], dim=1)
                            for c, i in zip(x, ident)])
    if isinstance(x, tuple):
        return _rebuild(x, [_pad(c, pad) for c in x])
    return torch.cat([x, x.new_zeros(x.shape[:-1] + (pad,))], dim=-1)


def _split(x, k: int, i: int, device: torch.device):
    """Shard i of k of a lane operand, contiguous, on `device`."""
    if isinstance(x, tuple):
        return _rebuild(x, [_split(c, k, i, device) for c in x])
    m = x.shape[-1] // k
    return x[..., i * m:(i + 1) * m].to(device).contiguous()


def _concat(parts: list, device: torch.device, n: int | None = None):
    """Shards (or per-device results) joined along the lane axis on
    `device`, cut to the first n lanes where the padding made more."""
    first = parts[0]
    if isinstance(first, tuple):
        return _rebuild(first, [_concat([p[f] for p in parts], device, n)
                                for f in range(len(first))])
    out = torch.cat([p.to(device) for p in parts], dim=-1)
    return out if n is None or out.shape[-1] <= n else out[..., :n].contiguous()


def shard(mesh: Mesh, x) -> Sharded:
    """A (16, N) limb vector, a PointArray or an ElGamal pair over the 'param'
    devices (of the first client row), padded to a multiple of the axis."""
    devs = mesh.param_devices()
    n = _lanes(x)
    x = _pad(x, (-n) % len(devs))
    return Sharded([_split(x, len(devs), i, d) for i, d in enumerate(devs)], n)


# shard_vector, shard_points and replicate keep the JAX package's names for
# parity; the port's own callers use ``shard`` and the sharded operations.
def shard_vector(mesh: Mesh, limbs: torch.Tensor) -> Sharded:
    """Shard a (16, N) limb vector over the 'param' axis."""
    return shard(mesh, limbs)


def shard_points(mesh: Mesh, p: PointArray) -> Sharded:
    return shard(mesh, p)


def replicate(mesh: Mesh, arr) -> list:
    """A copy of `arr` (a tensor or a tuple of them) on every 'param' device;
    a device that repeats shares one copy."""
    copies: dict = {}
    for d in mesh.param_devices():
        if d not in copies:
            copies[d] = (type(arr)(*[c.to(d) for c in arr]) if isinstance(arr, tuple)
                         else arr.to(d))
    return [copies[d] for d in mesh.param_devices()]


def lane_map(mesh: Mesh, fn, *args):
    """fn over the 'param' shards of its lane arguments (tensors, PointArrays
    and pairs whose last axis is the lanes; None passes as it is), one shard
    at a time on its device; the outputs, in the same forms, joined on the
    mesh's first device and cut back to the true lane count. For functions
    that are elementwise over the lanes: the Σ-protocol cores, whose
    transcripts are per lane."""
    lane_args = [a for a in args if a is not None]
    n = _lanes(lane_args[0])
    sharded = [shard(mesh, a) if a is not None else None for a in args]
    outs = []
    for i, d in enumerate(mesh.param_devices()):
        with _on_device(d):
            outs.append(fn(*[s.shards[i] if s is not None else None for s in sharded]))
    return _concat(outs, mesh.first, n)


# -- sharded reductions -------------------------------------------------------


def _gather_tree_add(parts: list, device: torch.device) -> PointArray:
    """Per-device partial points copied to `device` and summed there: the
    group-operation analogue of psum (point addition can't ride a psum)."""
    gathered = _concat(parts, device)
    return curve.tree_sum(gathered, axis=0)


def sharded_msm(mesh: Mesh, points: PointArray, scalars: torch.Tensor) -> PointArray:
    """Σ k_i·P_i with the i axis sharded over 'param': a local MSM per device
    (``msm_flat``), the single-point partials copied to the first device and
    summed there (``point_sum``). Result (16, 1) on the mesh's first device.
    Lanes are padded to a multiple of the 'param' axis with identity points /
    zero scalars (inert terms)."""
    pts, scal = shard(mesh, points), shard(mesh, scalars)
    parts = []
    for i, d in enumerate(mesh.param_devices()):
        with _on_device(d):
            parts.append(msm_mod.msm(pts.shards[i], scal.shards[i]))
    return _gather_tree_add(parts, mesh.first)


def _groups_divide(mesh: Mesh, lanes: int, group: int) -> bool:
    g = lanes // group
    return g > 0 and g % mesh.shape["param"] == 0


def sharded_msm_grouped(mesh: Mesh, points: PointArray, scalars: torch.Tensor,
                        group: int) -> PointArray:
    """Per-group MSMs with the GROUP axis sharded over 'param':
    (16, G·group) → (16, G) on the mesh's first device. The prove-path
    primitive: the chunk-batched Bulletproofs prover's A/S and IPA L/R MSMs
    are per-chunk reductions, so distributing whole chunks across devices
    needs no collective at all (the reference's rayon-chunk parallelism,
    range_proof_vec/mod.rs:53-78, mapped onto the mesh). Falls back to the
    local ``msm_grouped`` when G doesn't divide over the axis, as the JAX
    function does."""
    if not _groups_divide(mesh, scalars.shape[-1], group):
        out = msm_mod.msm_grouped(points, scalars, group)
        return PointArray(*[c.to(mesh.first) for c in out])
    return lane_map(mesh, lambda p, k: msm_mod.msm_grouped(p, k, group), points, scalars)


def sharded_tree_sum_groups(mesh: Mesh, p: PointArray, group: int) -> PointArray:
    """Per-group point sums with the group axis sharded over 'param'
    ((16, G·group) → (16, G)): the prover's A-term reduction. The same
    fallback as ``sharded_msm_grouped``."""
    if not _groups_divide(mesh, p.x.shape[-1], group):
        out = curve.tree_sum_groups(p, group)
        return PointArray(*[c.to(mesh.first) for c in out])
    return lane_map(mesh, lambda q: curve.tree_sum_groups(q, group), p)


def _table_on(table, device: torch.device) -> PointArray:
    """A fixed-base table on `device`: a ``FixedBase``'s own cached table
    there, or a copy of a table given as points."""
    if isinstance(table, fixed_base.FixedBase):
        return table.table(device)
    return PointArray(*[c.to(device) for c in table])


def sharded_commit(mesh: Mesh, table, scalars: torch.Tensor) -> PointArray:
    """Fixed-base commit lanes sharded over 'param' (the table, a
    ``FixedBase`` or its points, on each shard's device); elementwise, no
    collectives."""
    return lane_map(mesh, lambda k: fixed_base.mul(_table_on(table, k.device), k), scalars)


def sharded_pair_add(mesh: Mesh, a, b):
    """Elementwise homomorphic accumulate of ElGamal pair arrays ((L, R)
    PointArrays) sharded over 'param': add_rp_vec_vec under sharding."""
    return lane_map(mesh, lambda x, y: type(a)(curve.add(x.L, y.L), curve.add(x.R, y.R)),
                    a, b)


def sharded_bsgs(mesh: Mesh, points: PointArray, table_m: int,
                 n_bits: int) -> tuple[torch.Tensor, torch.Tensor]:
    """BSGS extraction with the point lanes sharded over 'param': each device
    walks its own lanes against its own copy of the table (built once per
    device; the walk is elementwise, no collectives). Returns (values (16, N)
    scalar limbs, ok (N,)) on the mesh's first device."""
    max_it = max(1, (1 << n_bits) // table_m)

    def walk(p: PointArray):
        keys, vals = bsgs.build_table(table_m, p.device)
        return bsgs.solve_with_table(keys, vals, bsgs.neg_mG_coords(table_m, p.device), p,
                                     table_m, max_it)

    return lane_map(mesh, walk, points)


def describe(mesh: Mesh) -> dict:
    """The mesh's shape and devices as strings, for a report line."""
    return {"shape": dict(mesh.shape),
            "devices": [[str(d) for d in row] for row in mesh.devices],
            "distinct_devices": len({d for row in mesh.devices for d in row})}
