"""The port's ``fl/config.py`` (``load_experiment`` on its own YAML reader)
against the JAX package's (on ``yaml``): for every file of ``configs/`` and
for edited copies (lazy evaluation, ``--initstd``, defaults left out, a raw
``intrinsic_dimension``, an unknown ``enc_type``) both give the same
``ExperimentConfig``; the server's configuration is compared as the JAX one
reaches the port (``dataclasses.asdict`` → ``convert.server_config_from_dict``).
Tolerance: none (the initial model bit for bit)."""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from rofl_tpu.fl import config as jconfig
from rofl_tpu_torch import convert
from rofl_tpu_torch.fl import config

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = sorted((ROOT / "configs").glob("*.yml"))


def same_experiment(port, jax):
    want = convert.server_config_from_dict(dataclasses.asdict(jax.server), "cpu")
    got, want = dataclasses.asdict(port.server), dataclasses.asdict(want)
    got_model, want_model = got.pop("initial_model"), want.pop("initial_model")
    assert got == want
    if want_model is None:
        assert got_model is None
    else:
        assert got_model.dtype == np.float32 and np.array_equal(got_model, want_model)
    for f in dataclasses.fields(port):
        if f.name != "server":
            assert getattr(port, f.name) == getattr(jax, f.name), f.name
            assert type(getattr(port, f.name)) is type(getattr(jax, f.name)), f.name


@pytest.mark.parametrize("lazy", [False, True])
@pytest.mark.parametrize("path", CONFIGS, ids=lambda p: p.name)
def test_every_experiment_file_loads_as_in_the_jax_package(path, lazy, monkeypatch):
    monkeypatch.chdir(ROOT)  # model_init_path is relative to the repository
    port = config.load_experiment(str(path), lazy_eval=lazy, device="cpu")
    same_experiment(port, jconfig.load_experiment(str(path), lazy_eval=lazy))
    assert port.server.device == "cpu" and port.server.lazy_verification == lazy


EDITS = {
    "initstd": ("", 0.05),  # example_config: num_params 19090 and no model file
    "defaults": ("crypto:\n  enc_type: l2\nclient:\n  num_params: 7\n", 0.0),
    "raw_intrinsic": ("server:\n  intrinsic_dimension: '5000'\ncrypto:\n  enc_type: Plain\n",
                      0.0),
    "bare": ("environment:\n  num_clients: 3\n", 0.5),
}


@pytest.mark.parametrize("name", sorted(EDITS))
def test_edited_files_load_as_in_the_jax_package(name, tmp_path, monkeypatch):
    text, std = EDITS[name]
    if not text:
        text = (ROOT / "configs" / "example_config.yml").read_text()
    path = tmp_path / f"{name}.yml"
    path.write_text(text)
    monkeypatch.chdir(ROOT)
    port = config.load_experiment(str(path), std_init=std, device="cpu")
    same_experiment(port, jconfig.load_experiment(str(path), std_init=std))
    if name == "defaults":
        assert port.server.crypto.l2_value_range == 32  # not CryptoConfig's 16
    if name == "initstd":
        assert port.server.initial_model.shape == (19090,)


def test_an_unknown_enc_type_raises_in_both(tmp_path):
    path = tmp_path / "bad.yml"
    path.write_text("crypto:\n  enc_type: L2  # not a name the loader knows\n")
    for load in (jconfig.load_experiment, config.load_experiment):
        with pytest.raises(ValueError, match="enc_type"):
            load(str(path))
    assert config.ENC_TYPE_NAMES == jconfig.ENC_TYPE_NAMES
