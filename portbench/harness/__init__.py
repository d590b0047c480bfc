"""The benchmark's general code: the run, the traffic generator, the
timed entries, the trace reduction and the correctness check."""
