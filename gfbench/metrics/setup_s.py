"""setup_s: seconds from the process's start to the window's first timed
operation (imports, the card's start, the complex from the seed, the
grids and their pack, warm-up and recording)."""


def read(run):
    return run.setup_s
