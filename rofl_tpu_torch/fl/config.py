"""Experiment YAML configuration — counterpart of ``rofl_tpu.fl.config``
(config_server.rs:16-123 semantics), read with the port's own YAML subset
reader (``fl/yaml_subset.py``).

Same schema as ``configs/*.yml`` (environment / server / client / crypto /
dataset sections). fp_bits / fp_frac are runtime configuration, as in the JAX
package. Kept from it: an unknown ``enc_type`` raises ``ValueError``;
``l2_value_range`` defaults to 32 here (16 in ``CryptoConfig``);
``num_params`` is the length of the model file when ``model_init_path`` is
set; ``--initstd`` draws ``default_rng(0).normal(0, std, n)`` as float32;
``intrinsic_dimension`` is the raw YAML value. The one addition is
``device``, where the server's crypto runs (default ``"cuda"``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..crypto.fp_codec import FpConfig
from . import params as P
from .server import ServerConfig
from .util import read_model_from_file
from .yaml_subset import safe_load

ENC_TYPE_NAMES = {
    "Range": P.ENC_RANGE_TYPE,
    "l2": P.ENC_L2_TYPE,
    "Plain": P.PLAIN_TYPE,
    "RangeCompressed": P.ENC_RANGE_COMPRESSED_TYPE,
    "l2Compressed": P.ENC_L2_COMPRESSED_TYPE,
}


@dataclass
class ExperimentConfig:
    server: ServerConfig
    model_name: str = "mnist_dev"
    dataset: str = "mnist"
    num_epochs: int = 1
    batch_size: int = 24
    optimizer: str = "Adam"
    local_learning_rate: float = 0.001
    intrinsic_dimension: int | None = None


def load_experiment(path: str, lazy_eval: bool = False, std_init: float = 0.0,
                    device="cuda") -> ExperimentConfig:
    with open(path) as f:
        doc = safe_load(f.read())

    env = doc.get("environment", {})
    srv = doc.get("server", {})
    client = doc.get("client", {})
    crypto = doc.get("crypto", {})
    training = client.get("benign_training", {}) or {}
    dataset = (doc.get("dataset", {}) or {}).get("dataset", "mnist")

    enc_name = crypto.get("enc_type", "Range")
    if enc_name not in ENC_TYPE_NAMES:
        # fail fast like config_server.rs's panic: a silent fallback would
        # turn the crypto checks off
        raise ValueError(f"unknown crypto.enc_type {enc_name!r}; "
                         f"expected one of {sorted(ENC_TYPE_NAMES)}")
    enc_type = ENC_TYPE_NAMES[enc_name]
    fp = FpConfig(int(crypto.get("fp_bits", 16)), int(crypto.get("fp_frac", 7)))
    crypto_cfg = P.CryptoConfig(
        value_range=int(crypto.get("value_range", 8)),
        n_partition=int(crypto.get("n_partition", 1)),
        l2_value_range=int(crypto.get("l2_value_range", 32)),
        check_percentage=float(crypto.get("check_percentage", 1.0)),
        enc_type=enc_type,
        fp=fp,
    )

    init_path = client.get("model_init_path")
    num_params = int(client.get("num_params", 0))
    initial_model = None
    if init_path:
        initial_model = read_model_from_file(init_path)
        num_params = len(initial_model)
    elif std_init > 0 and num_params:
        initial_model = np.random.default_rng(0).normal(
            0, std_init, num_params).astype(np.float32)

    server_cfg = ServerConfig(
        model_id=1,
        num_clients=int(env.get("num_clients", 1)),
        num_params=num_params,
        num_rounds=int(srv.get("num_rounds", 10)),
        learning_rate=float(srv.get("global_learning_rate", 1.0)),
        enc_type=enc_type,
        crypto=crypto_cfg,
        model_config={
            "client_batch_size": int(training.get("batch_size", 24)),
            "num_local_epochs": int(training.get("num_epochs", 1)),
            "optimizer": str(training.get("optimizer", "Adam")),
            "fp_bits": fp.n_bits,
            "fp_frac": fp.n_frac,
        },
        lazy_verification=lazy_eval,
        initial_model=initial_model,
        device=device,
    )
    return ExperimentConfig(
        server=server_cfg,
        model_name=str(client.get("model_name", "mnist_dev")),
        dataset=dataset,
        num_epochs=int(training.get("num_epochs", 1)),
        batch_size=int(training.get("batch_size", 24)),
        optimizer=str(training.get("optimizer", "Adam")),
        local_learning_rate=float(training.get("learning_rate", 0.001)),
        intrinsic_dimension=srv.get("intrinsic_dimension"),
    )
