"""``ramp_read``: a 4-point Hermite read of ``rows`` lanes at ``n``
positions each from a table of planar buffers.  The operation needs the
table span its positions touch (``table_frames`` frames of ``channels``
channels over all rows), the positions, and the output, each once; 19
float32 operations per output sample (the four taps' polynomial)."""

NEEDLE = "ramp_read"


def cost(rows: int, n: int, channels: int, table_frames: int):
    nbytes = 4 * (table_frames * channels + rows * n + rows * channels * n)
    return nbytes, 19 * rows * channels * n
