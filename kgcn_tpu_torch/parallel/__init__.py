"""The port's parallel layer over ``torch.distributed`` — the counterpart
of ``kgcn_tpu/parallel``: the launcher (``launch.py``), the mesh and its
collectives (``mesh.py``), data-parallel training (``dp.py``),
fold-parallel cross-validation (``cv.py``), the edge-partitioned
aggregation (``edge_partition.py``), the big-graph KG trainer with
sharded checkpoints (``big_graph.py``), tensor-parallel training over a
``model`` axis (``tp.py``) and the GPipe pipeline over a ``pipe`` axis
(``pp.py``).

One process drives one device (PyTorch's idiom; ``kgcn_tpu`` runs one
controller over many devices): NCCL between GPU ranks, one rank a GPU,
gloo between CPU ranks."""
