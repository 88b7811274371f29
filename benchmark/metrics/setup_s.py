"""setup_s: seconds from the process start to the start of the
measured window (imports, weights, inputs, the build on a first run, the
warm-up)."""


def read(res, cell):
    return res["setup_s"]
