"""scalar_mul_roofline.client: the ladder launches' share of their roofline, in
percent (csrc/scalar_mul.cu's kernel device time against harness/roofline.py)."""

from portbench.harness.readers import scalar_mul_roofline


def read(run):
    return scalar_mul_roofline(run)
