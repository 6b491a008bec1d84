"""Local trainer — counterpart of ``rofl_tpu.models.trainer`` (the
fl-analysis adapter, analysis_client.py:14-55): set the weights from a flat
vector, train for the local epochs, return the new flat weights.

The step is plain SGD, ``w - lr * g`` (``trainer.py:82``); with an
``IntrinsicWrapper`` the FL vector is z and the gradient reaches it through
``intrinsic.project``. The network is applied to a flat vector with
``torch.func.functional_call`` over views of it, in ``ravel_pytree``'s order.

On the card the products run in float32: cuDNN's convolutions would default
to TF32, so the step and ``evaluate`` run under ``float32_products``
(``torch.backends.cudnn.allow_tf32`` off while a trainer is inside);
matmuls stay at torch's default (no TF32). Everything runs on ``device``
(default ``"cuda"``).
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import torch
from torch.func import functional_call

from . import data as D
from .intrinsic import IntrinsicWrapper
from .networks import build_model, init_flat, unflatten


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """-mean(log_softmax(logits)[label]) as the JAX package writes it: a label
    outside the classes picks NaN (``take_along_axis`` fills), it does not
    raise as ``F.cross_entropy`` would."""
    logp = torch.log_softmax(logits, dim=-1)
    n_cls = logits.shape[-1]
    labels = labels.long()
    labels = torch.where(labels < 0, labels + n_cls, labels)
    inside = (labels >= 0) & (labels < n_cls)
    picked = logp.gather(1, labels.clamp(0, n_cls - 1)[:, None])[:, 0]
    picked = torch.where(inside, picked, torch.full_like(picked, float("nan")))
    return -picked.mean()


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    return (logits.argmax(dim=1) == labels.long()).float().mean()


_TF32_LOCK = threading.Lock()
_TF32_USERS = 0
_TF32_SAVED = True


@contextlib.contextmanager
def float32_products(device):
    """A context in which cuDNN computes in float32 (no TF32) on `device`.
    The switch is the process's, so it is off while any trainer thread is
    inside and back as it was when the last one leaves."""
    global _TF32_USERS, _TF32_SAVED
    if torch.device(device).type != "cuda":
        yield
        return
    with _TF32_LOCK:
        if _TF32_USERS == 0:
            _TF32_SAVED = torch.backends.cudnn.allow_tf32
            torch.backends.cudnn.allow_tf32 = False
        _TF32_USERS += 1
    try:
        yield
    finally:
        with _TF32_LOCK:
            _TF32_USERS -= 1
            if _TF32_USERS == 0:
                torch.backends.cudnn.allow_tf32 = _TF32_SAVED


class Trainer:
    """One FL client's local trainer (full parameters, or z with
    `intrinsic_dim`)."""

    def __init__(self, model_name: str, dataset: str, client_id: int = 0,
                 num_clients: int = 1, batch_size: int = 32, local_epochs: int = 1,
                 lr: float = 0.1, seed: int = 0, intrinsic_dim: int | None = None,
                 device="cuda"):
        self.device = torch.device(device)
        self.module, _ = build_model(model_name)
        self.module.to(self.device)
        self.batch_size = batch_size
        self.local_epochs = local_epochs
        self.lr = lr
        x, y = D.load_dataset(dataset, "train")
        self.x, self.y = D.client_shard(x, y, client_id, num_clients)
        self._x = torch.from_numpy(np.ascontiguousarray(self.x)).to(self.device)
        self._y = torch.from_numpy(np.ascontiguousarray(self.y)).to(self.device)
        flat = init_flat(self.module, seed, self.device)
        self.full_dim = int(flat.shape[0])
        self.intrinsic = (IntrinsicWrapper(flat, intrinsic_dim, seed=seed + 1)
                          if intrinsic_dim else None)
        self.weights = (np.zeros(intrinsic_dim, np.float32) if intrinsic_dim
                        else flat.cpu().numpy())
        self.round_log: dict[int, dict] = {}  # round → steps and wall ms of train()

    @property
    def num_params(self) -> int:
        return len(self.weights)

    def logits(self, w: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
        flat = self.intrinsic.theta(w) if self.intrinsic is not None else w
        return functional_call(self.module, unflatten(self.module, flat), (xb,))

    def step(self, w: torch.Tensor, xb: torch.Tensor, yb: torch.Tensor):
        """One SGD step: (w - lr * ∇loss, loss)."""
        w = w.detach().requires_grad_(True)
        with float32_products(self.device):
            loss = cross_entropy(self.logits(w, xb), yb)
            (g,) = torch.autograd.grad(loss, w)
        return (w - self.lr * g).detach(), loss.detach()

    def set_weights(self, flat: np.ndarray):
        self.weights = np.asarray(flat, np.float32)

    def get_weights(self) -> np.ndarray:
        return np.asarray(self.weights, np.float32)

    def train(self, round_id: int = 0) -> np.ndarray:
        """local_epochs of minibatch SGD over the shard in the order of
        ``default_rng(round_id).permutation``, full batches only; returns the
        new flat weights."""
        t0 = time.perf_counter()
        w = torch.as_tensor(self.weights, dtype=torch.float32, device=self.device)
        n = len(self.x)
        order = np.random.default_rng(round_id).permutation(n)
        steps = 0
        for _ in range(self.local_epochs):
            for s in range(0, n - self.batch_size + 1, self.batch_size):
                idx = torch.from_numpy(order[s:s + self.batch_size]).to(self.device)
                w, _ = self.step(w, self._x[idx], self._y[idx])
                steps += 1
        self.weights = w.cpu().numpy().astype(np.float32)
        self.round_log[round_id] = {"steps": steps, "ms": 1e3 * (time.perf_counter() - t0)}
        return self.weights

    def evaluate(self, split: str = "test") -> tuple[float, float]:
        """(loss, accuracy) on the first 512 samples of the test set, which is
        MNIST's for 28×28×1 inputs and CIFAR-10's for anything else, as in the
        JAX package (reference hazard 9)."""
        name = "mnist" if self.x.shape[1:] == (28, 28, 1) else "cifar10"
        x, y = D.load_dataset(name, split)
        xb = torch.from_numpy(x[:512]).to(self.device)
        yb = torch.from_numpy(y[:512]).to(self.device)
        w = torch.as_tensor(self.weights, dtype=torch.float32, device=self.device)
        with torch.no_grad(), float32_products(self.device):
            logits = self.logits(w, xb)
            return float(cross_entropy(logits, yb)), float(accuracy(logits, yb))
