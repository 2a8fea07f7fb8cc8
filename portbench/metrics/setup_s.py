"""Seconds from the process's start to the window: CUDA, the program's
kernel libraries, the operands, the cell's warm-up."""


def read(rec):
    return rec["setup_s"]
