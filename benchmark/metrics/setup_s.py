"""Process start until the window opens (host clock): kernel builds or
loads, the body and grid, the program's set-up (weight images, packed
weights), the warm-up. The seconds of the benchmark's own fits, or of
their loads from the fit cache, are left out (subject.capture_weights
times them), so that the number is the same whether the cache was there."""


def read(run):
    return run.setup_s
