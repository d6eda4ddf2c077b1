"""``setup_s``: seconds from the process's start to its first timed solve
(imports, the CUDA context, inputs from the seed, kernel builds or loads,
the conformance probes and the warm-up solve)."""


def read(run):
    return run.setup_s
