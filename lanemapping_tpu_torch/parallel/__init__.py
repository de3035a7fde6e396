"""Data parallelism (port of `lanemapping_tpu/parallel/`).

``mesh`` names the devices of the ``data`` axis and splits a batch by rows
over them; ``dist`` starts and queries the process group, and holds the
collectives the training step, the losses, BatchNorm and the Runner use.
Under pjit the JAX train step works on the logical global batch; the port
keeps those semantics with one process (rank) per device of the mesh: each
rank's loss is its contribution to the global loss, BatchNorm normalises
with the global batch's statistics, and the float32 gradients are summed
over the ranks.  At a world of one no collective runs.
"""
