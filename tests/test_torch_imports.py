"""The port stands alone: no module of rofl_tpu_torch, and not chip_smoke.py,
imports jax, flax or anything of rofl_tpu."""

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "rofl_tpu")
FILES = sorted((ROOT / "rofl_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            names += [alias.name for alias in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module or "")
    return names


def test_the_port_has_the_modules_of_the_slice():
    have = {str(p.relative_to(ROOT / "rofl_tpu_torch")) for p in FILES[:-1]}
    want = {"bindings.py", "convert.py", "spec/field.py", "spec/scalar.py",
            "spec/ristretto.py", "spec/generators.py", "spec/keccak.py", "spec/merlin.py",
            "crypto/fp_codec.py", "crypto/pedersen.py", "crypto/serde_vec.py",
            "crypto/batch_transcript.py", "crypto/sigma.py", "ops/dispatch.py", "ops/fe.py",
            "ops/sc.py", "ops/kernels.py", "ops/curve.py", "ops/fixed_base.py", "ops/bsgs.py",
            "ops/keccak_batch.py"}
    assert want <= have


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_import_of_jax_or_the_jax_package(path):
    bad = [m for m in imported_modules(path)
           if any(m == f or m.startswith(f + ".") for f in FORBIDDEN)]
    assert not bad, f"{path} imports {bad}"


def test_kernel_sources_are_in_the_package():
    from rofl_tpu_torch.ops import kernels

    for src in kernels.KERNEL_SOURCES.values():
        text = (kernels.CSRC_DIR / src).read_text()
        assert "__global__" in text and 'extern "C"' in text
        assert "torch/extension.h" not in text
    assert set(kernels.LAUNCHES) == set(kernels.KERNEL_SOURCES) == set(kernels._ARGTYPES)
    assert {"sc_mul", "sc_add", "sc_sub", "scalar_mul"} <= set(kernels.KERNEL_SOURCES)
    for name in kernels.KERNEL_SOURCES:  # each kernel has its plain version beside it
        assert callable(getattr(kernels, name)) and callable(getattr(kernels, name + "_ref"))


def test_the_port_does_not_carry_the_batched_verifier_as_a_stub():
    from rofl_tpu_torch.crypto import sigma

    assert not hasattr(sigma, "square_rand_proof_verify_batched")


def test_no_python_integer_sum_in_the_cancelling_blindings():
    import inspect

    from rofl_tpu_torch.crypto import pedersen

    source = inspect.getsource(pedersen.cancelling_scalar_limbs)
    assert "unpack_scalars" not in source and "sum_reduce" in source
