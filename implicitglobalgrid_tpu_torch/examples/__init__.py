"""The reference examples on the port's API.

Each runs as ``python -m implicitglobalgrid_tpu_torch.examples.<name>
[--cpu]``: with ``--cpu`` on the CPU with 8 ranks at the JAX example's CPU
sizes, else on the card at its full sizes; unchanged under ``torchrun
--nproc_per_node=N`` (a process group of N processes, each owning a box of
the ranks: NCCL on the cards, gloo with ``--cpu``). Each has a function that
returns its final `gather_interior` on process 0 (None elsewhere);
`diffusion3D_multixpu`'s returns its snapshots' frames with it.
"""
