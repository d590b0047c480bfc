"""setup_s (s, host clock): from the start of the process to the first
timed block: importing, loading (or building) the kernel library, drawing
the graph and its tables from the seed, building the programs, and the
warm-up blocks."""


def read(r):
    return r.setup_s
