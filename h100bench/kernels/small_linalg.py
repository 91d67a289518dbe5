"""The solver's small-matrix kernels (``csrc/small_linalg.cu``): the
polish's 9x9 symmetric eigensolve and its two 3x3 SVDs, a round.

Work a request: each solver round, for each pair, cyclic Jacobi with a
fixed schedule (8 sweeps of 36 rotations of a 9x9 and its V, 12 (n - 1) +
15 operations each; 6 one-sided sweeps of 3 rotations of 65 operations
and ~200 for U on each 3x3), float32 on the CUDA cores; matrices read and
written once.
"""

SYMBOLS = ("anon::eigh_kernel", "anon::svd3_kernel")
PEAK = 67e12  # float32 outside the tensor cores


def round_work(B):
    eigh = 8 * 9 * 8 // 2 * (12 * 8 + 15)
    svd = 6 * 3 * 65 + 200
    return B * (eigh + 2 * svd), 4 * B * ((81 + 9 + 81) + 2 * (9 + 9 + 3 + 9))


def work(sh):
    f, b = round_work(sh["B"])
    return sh["rounds"] * f, sh["rounds"] * b
