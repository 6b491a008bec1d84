"""Generate initial global-model weight files (one float per line) —
counterpart of ``scripts/gen_init_models.py`` (the reference's models/*.txt,
loaded by params.rs:984-997).

Intrinsic-dimension files are all-zeros like the reference's (the intrinsic
offset z starts at 0; theta = theta0 + P z); with ``--full``, the full-model
files of mnist_dev and cifar_lenet5 are their Flax initialisations at
PRNGKey(0), made by the port's ``networks.init_flat``, in ``ravel_pytree``'s
order.

Usage: python -m rofl_tpu_torch.scripts.gen_init_models [--out build/models] [--full]

``--out`` defaults to ``build/models``: the repo's ``models/`` holds the
committed files.
"""

import argparse
import os

import numpy as np

INTRINSIC_FILES = [
    ("mnist_dev_intrinsic_5k.txt", 5000),
    ("cifar_lenet5_intrinsic_12k.txt", 12000),
    ("resnet18_intrinsic_25k.txt", 25000),
    ("resnet18_intrinsic_40k.txt", 40000),
    ("resnet18_intrinsic_45k.txt", 45000),
    ("resnet18_intrinsic_50k.txt", 50000),
    ("resnet18_intrinsic_55k.txt", 55000),
]
FULL_FILES = [("mnist_dev", "mnist_dev_initialized.txt"),
              ("cifar_lenet5", "cifar_lenet5_initialized.txt")]


def write_vec(path: str, vec):
    with open(path, "w") as f:
        for v in vec:
            f.write(f"{float(v)}\n")
    print(f"wrote {path} ({len(vec)} params)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="rofl_tpu_torch.scripts.gen_init_models")
    ap.add_argument("--out", default="build/models")
    ap.add_argument("--full", action="store_true",
                    help="also generate full-model (non-intrinsic) inits")
    ap.add_argument("--device", default="cuda",
                    help="where --full's initialisation runs: cuda or cpu")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    # intrinsic files: zeros (training starts at theta0, z=0)
    for name, d in INTRINSIC_FILES:
        write_vec(os.path.join(args.out, name), np.zeros(d, np.float32))

    if args.full:
        from ..models.networks import build_model, init_flat

        for name, fname in FULL_FILES:
            module, _ = build_model(name)
            flat = init_flat(module, 0, args.device).cpu().numpy()
            write_vec(os.path.join(args.out, fname), flat)


if __name__ == "__main__":
    main()
