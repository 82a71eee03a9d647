"""Cell updates a second: every cell update of the window (the implicit
global grid's cells a step, times the members), over the window's wall
seconds (host clock, first call's start to last call's return)."""


def read(run):
    return run.cells_per_step * run.window.steps / run.window_s
