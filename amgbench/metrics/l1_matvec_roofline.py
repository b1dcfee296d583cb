"""l1_matvec_roofline: level 1's A.matvec, L2 flushed before each launch,
as a % of its HBM bound (amgbench/roofline.py)."""
from amgbench.roofline import level_matvec_share


def read(run):
    return level_matvec_share(run, 1)
