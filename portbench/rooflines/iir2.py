"""``iir2``: the second-order linear recurrence ``s[t] = A[t] s[t-1] +
b[t]`` of a TPT biquad or SVF over ``rows`` signal rows of ``n`` samples
with per-sample coefficients shared by the ``rows / coef_rows`` channels of
a filter.  The operation needs the signal (one value per row and sample),
the coefficients (three per filter and sample: a1, a2, a3 fix A and b's
scale) and the output state (two per row and sample), each once; 6 float32
operations per row and sample (a 2x2 product and a sum)."""

NEEDLE = "iir2"


def cost(rows: int, coef_rows: int, n: int):
    nbytes = 4 * n * (rows * 1 + coef_rows * 3 + rows * 2)
    return nbytes, 6 * rows * n
