"""setup_s: host seconds from the process's start to the end of the
warm-up: the library's load (and its build in a fresh checkout), the
pool drawn and encoded, the plans staged, every study served twice."""


def read(ctx):
    return ctx["setup_s"]
