"""Multi-process parallelism over torch.distributed: the (data, model)
process mesh, the DiT's tensor-parallel plan and sharded construction
(``mesh.py``), and the multi-process dry runs with their spawn helper
(``dryrun.py``)."""
