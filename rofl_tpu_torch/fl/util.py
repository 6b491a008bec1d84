"""Chunked transport and model files — counterpart of ``rofl_tpu.fl.util``
(rofl_service util.rs ``DataBlockStorage``), an own copy: host Python and
numpy only."""

from __future__ import annotations

import numpy as np

CHUNK_SIZE = 1 << 20  # 1 MiB server blocks (server.rs:35)
NUM_FLOATS_PACKET = 10000  # client↔trainer float blocks (trainclient.rs:11)


class DataBlockStorage:
    """Ordered block accumulator with round-id tracking (util.rs:3-60)."""

    def __init__(self):
        self.round_id = -1
        self.num_blocks = 0
        self.blocks: list[bytes | None] = []

    def init(self, round_id: int, num_blocks: int):
        self.round_id = round_id
        self.num_blocks = num_blocks
        self.blocks = [None] * num_blocks

    def apply(self, block_number: int, data: bytes) -> bool:
        """Store block `block_number`; False, and nothing stored, for a
        number outside the announced count."""
        if 0 <= block_number < self.num_blocks:
            self.blocks[block_number] = data
            return True
        return False

    def is_done(self) -> bool:
        return self.num_blocks > 0 and all(b is not None for b in self.blocks)

    def data(self) -> bytes:
        return b"".join(self.blocks)  # type: ignore[arg-type]


def chunk_bytes(data: bytes, chunk_size: int = CHUNK_SIZE) -> list[bytes]:
    """`data` in blocks of `chunk_size`; empty data is one empty block."""
    return [data[i:i + chunk_size] for i in range(0, len(data), chunk_size)] or [b""]


def write_model_to_file(path: str, values: np.ndarray):
    """One float per line, ``f"{v}"`` of each numpy float32 as the JAX
    package writes it (under numpy 2 the float32 widened to a Python float:
    ``0.10000000149011612``, ``-0.0``, ``inf``, ``nan``; each reads back as
    the float32): server.rs write_global_model_to_file, the format of
    ``models/*.txt``."""
    with open(path, "w") as f:
        for v in np.asarray(values, np.float32):
            f.write(f"{v}\n")


def read_model_from_file(path: str) -> np.ndarray:
    """GlobalModel::new_from_file (params.rs:984-997): the float of every
    line that parses as one, as float32."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                try:
                    out.append(float(line))
                except ValueError:
                    pass
    return np.array(out, np.float32)
