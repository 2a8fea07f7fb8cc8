"""The program's kernels' share of their roofline: for each profiled call
or request, the least time (``counts/``) of each kernel wrapper that it
launched itself, summed over the device time of the program's own kernels
in the profiled part, in %."""
from portbench import roofline


def read(rec):
    return roofline.kernels_pct(rec)
