"""msm_roofline.server: the MSM launches' share of their roofline, in percent
(csrc/msm.cu's kernels' device time against harness/roofline.py)."""

from portbench.harness.readers import msm_roofline


def read(run):
    return msm_roofline(run)
