"""Set-up seconds: from the process's start to the window's, host clock
(imports, the kernels' load or build, the grid, the seed-made state, one
warm call of every shape)."""


def read(run):
    return run.setup_s
