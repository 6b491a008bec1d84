"""The port's trainer side (``rofl_tpu_torch.models``) against the JAX
package's (``rofl_tpu.models``), for the five families: mnist_dev, mnist_cnn
and cifar_lenet5 at full width, ResNet18 and CharLSTM at reduced width and
depth (``test_torch_models_kat.small_models``).

The JAX side of θ0, of one SGD step, of ``evaluate`` and of the projection
comes from ``tests/data/torch_port_models_kat.npz`` (no tier-1 test compiles
a network); the flat layout is held live against ``ravel_pytree``'s order
through ``jax.eval_shape``, which traces without compiling, at full width
for all five.

Tolerances: θ0 within 4 float32 ulps of each JAX value (its normals go
through XLA's erf⁻¹ polynomial), the LSTM's orthogonal kernels within 1e-5
absolute (QR in another LAPACK); one step's weights within 1e-4 of the
step's largest component, its loss within 1e-5 relative (products summed in
another order); ``evaluate``'s loss within 1e-5 relative and its accuracy
equal; P·z and Pᵀ·g within 1e-5 of their largest component."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rofl_tpu.models import networks as JN
from rofl_tpu.models import trainer as JT
from rofl_tpu_torch import convert
from rofl_tpu_torch.models import intrinsic, networks
from rofl_tpu_torch.models.trainer import Trainer, cross_entropy
from test_torch_models_kat import (BATCH, CASES, CLIENT_ID, CLIENTS, KAT_PATH, PROJECT_CASE,
                                   ROUND, SEED, first_batch, small_models)

torch.set_num_threads(2)
KAT = np.load(KAT_PATH)
CPU_CASES = [name for name, (_, _, dim) in CASES.items() if dim != 5000]  # d = 5000: the card
FAMILIES = {  # registry name → (JAX module, example input)
    "mnist_dev": (JN.MnistMLP(), (1, 28, 28, 1)),
    "mnist_cnn": (JN.MnistCNN(), (1, 28, 28, 1)),
    "cifar_lenet5": (JN.LeNet5(), (1, 32, 32, 3)),
    "resnet18": (JN.ResNet18(), (1, 32, 32, 3)),
    "shakespeare": (JN.CharLSTM(), (1, 80)),
    "resnet18_small": (small_models(JN)["resnet18_small"]()[0], (1, 32, 32, 3)),
    "shakespeare_small": (small_models(JN)["shakespeare_small"]()[0], (1, 80)),
}


@pytest.fixture(scope="module", autouse=True)
def small_port_models():
    with pytest.MonkeyPatch.context() as mp:
        for name, make in small_models(networks).items():
            mp.setitem(networks.MODEL_REGISTRY, name, make)
        yield


def jax_tree(name):
    module, shape = FAMILIES[name]
    x = jnp.zeros(shape, jnp.int32 if len(shape) == 2 else jnp.float32)
    return jax.eval_shape(module.init, jax.random.PRNGKey(0), x)


def jax_layout(tree):
    """(path, offset, shape) of each leaf, in ``ravel_pytree``'s order (the
    order of ``tree_leaves``)."""
    out, offset = [], 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out.append(("/".join(k.key for k in path[1:]), offset, tuple(leaf.shape)))
        offset += int(np.prod(leaf.shape))
    return out


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_flat_layout_is_ravel_pytrees(name):
    module, _ = networks.build_model(name)
    assert networks.layout(module) == jax_layout(jax_tree(name))
    sizes = {"mnist_dev": 19090, "cifar_lenet5": 62006}
    if name in sizes:  # the line counts of models/*_initialized.txt
        assert sum(p.numel() for p in module.parameters()) == sizes[name]


def ulps(got, want):
    return np.abs(got - want) / np.spacing(np.abs(want).astype(np.float32))


@pytest.mark.parametrize("name", sorted(k.split("/")[1] for k in KAT.files
                                        if k.startswith("theta0/")))
def test_theta0_is_the_flax_init(name):
    module, _ = networks.build_model(name)
    got = networks.init_flat(module, SEED, "cpu").numpy()
    want = KAT[f"theta0/{name}"]
    assert got.shape == want.shape and got.dtype == np.float32
    orthogonal = np.zeros(len(want), bool)
    for path, offset, shape in networks.layout(module):
        if path.split("/")[-2:-1] and path.split("/")[-2] in ("hi", "hf", "hg", "ho") \
                and path.endswith("kernel"):
            orthogonal[offset:offset + int(np.prod(shape))] = True
    assert np.max(ulps(got[~orthogonal], want[~orthogonal])) <= 4
    np.testing.assert_allclose(got[orthogonal], want[orthogonal], rtol=0, atol=1e-5)


def trainer_of(name):
    model, dataset, dim = CASES[name]
    return Trainer(model, dataset, client_id=CLIENT_ID, num_clients=CLIENTS, batch_size=BATCH,
                   seed=SEED, intrinsic_dim=dim, device="cpu")


def start_weights(name):
    model, _, dim = CASES[name]
    return KAT[f"{name}/w0"] if dim else KAT[f"theta0/{model.split('_intrinsic')[0]}"]


@pytest.mark.parametrize("name", CPU_CASES)
def test_one_sgd_step_and_evaluate(name):
    t = trainer_of(name)
    w0 = start_weights(name)
    xb, yb = first_batch(t)
    _, loss = t.step(torch.from_numpy(w0), torch.from_numpy(xb), torch.from_numpy(yb))
    want_loss = float(KAT[f"{name}/loss0"])
    if np.isnan(want_loss):  # emnist: labels ≥ 10 pick NaN (reference hazard 10)
        assert np.isnan(float(loss))
    else:
        assert abs(float(loss) - want_loss) <= 1e-5 * abs(want_loss)
    if f"{name}/eval" in KAT.files:
        t.set_weights(w0)
        loss_e, acc = t.evaluate()
        want_e = KAT[f"{name}/eval"]
        assert abs(loss_e - want_e[0]) <= 1e-5 * abs(want_e[0]) and acc == want_e[1]
    else:  # shakespeare: the char LSTM is handed CIFAR floats (reference hazard 9)
        with pytest.raises(ValueError, match="integer"):
            t.evaluate()
    t.set_weights(w0)
    w1 = t.train(ROUND)
    want = KAT[f"{name}/w1"]
    assert w1.dtype == np.float32 and np.isfinite(w1).all()
    assert np.max(np.abs(w1 - want)) <= 1e-4 * np.max(np.abs(want - w0))
    assert t.round_log[ROUND]["steps"] == 1


def test_projection_and_its_transpose():
    d = CASES[PROJECT_CASE][2]
    D = KAT[f"{PROJECT_CASE}/g"].shape[0]
    z = torch.from_numpy(KAT[f"{PROJECT_CASE}/w0"])
    got = intrinsic.project_forward(z, D, SEED + 1).numpy()
    want_p = KAT[f"{PROJECT_CASE}/project"]
    assert np.max(np.abs(got - want_p)) <= 1e-5 * np.max(np.abs(want_p))
    g = torch.from_numpy(KAT[f"{PROJECT_CASE}/g"])
    got = intrinsic.project_transpose(g, d, SEED + 1).numpy()
    want = KAT[f"{PROJECT_CASE}/project_transpose"]
    assert np.max(np.abs(got - want)) <= 1e-5 * np.max(np.abs(want))
    # project's backward is project_transpose, tile by tile as a whole
    zz = z.clone().requires_grad_(True)
    (grad,) = torch.autograd.grad(intrinsic.project(zz, D, SEED + 1), zz, g)
    torch.testing.assert_close(grad, intrinsic.project_transpose(g, d, SEED + 1), rtol=0, atol=0)
    whole = intrinsic.TILE_LANES
    try:  # tiles of 1000 rows: the same P, the products summed in other blocks
        intrinsic.TILE_LANES = 1000 * d
        tiled = intrinsic.project_forward(z, D, SEED + 1).numpy()
    finally:
        intrinsic.TILE_LANES = whole
    assert np.max(np.abs(tiled - want_p)) <= 1e-5 * np.max(np.abs(want_p))


def test_cross_entropy_keeps_the_nan_of_out_of_range_labels():
    logits = np.random.default_rng(3).standard_normal((4, 10)).astype(np.float32)
    for labels in ([1, 2, 3, 9], [1, 10, 3, 46], [-1, 2, 3, 9]):  # -1 wraps to 9
        want = float(JT.cross_entropy(jnp.asarray(logits), jnp.asarray(labels)))
        got = float(cross_entropy(torch.from_numpy(logits), torch.tensor(labels)))
        assert np.isnan(got) == np.isnan(want)
        if not np.isnan(want):
            assert abs(got - want) <= 1e-6 * abs(want)


def test_flax_params_through_convert():
    module, _ = networks.build_model("cifar_lenet5")
    flat = KAT["theta0/cifar_lenet5"]
    tree = jax_tree("cifar_lenet5")
    leaves, offset = [], 0
    for leaf in jax.tree_util.tree_leaves(tree):
        n = int(np.prod(leaf.shape))
        leaves.append(flat[offset:offset + n].reshape(leaf.shape))
        offset += n
    params = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(tree), leaves)
    nested = jax.tree_util.tree_map(np.asarray, params)
    np.testing.assert_array_equal(convert.flax_params_to_flat(nested, module), flat)
    convert.flat_to_module(module, flat, "cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 32, 32, 3)).astype(np.float32))
    direct = torch.func.functional_call(module, networks.unflatten(module, torch.from_numpy(flat)),
                                        (x,))
    torch.testing.assert_close(module(x), direct, rtol=0, atol=0)
