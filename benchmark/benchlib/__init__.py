"""The benchmark's own machinery: the spec's resolution by name (`spec`),
the program's block layout (`layout`), what a generator's window is made
of (`window`),
the trace reduction (`trace`, `intervals`), the table of peaks (`peaks`)
and one run of a cell (`harness`). Nothing here imports the measured
program; the model adapters under ``models/`` drive it."""
