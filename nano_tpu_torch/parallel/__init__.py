"""Parallelism on ``torch.distributed``: the mesh, the cuts of tensor
parallelism (``parallel.mesh``) and a launcher of ranks on one host
(``parallel.launch``)."""
