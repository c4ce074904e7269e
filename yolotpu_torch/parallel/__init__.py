"""Multi-GPU (M13): meshes and shardings (``mesh``), the collectives
(``comm``), the sharded integer forward (``forward``), the launcher
(``launch``) and the five-stage dryrun (``dryrun``), on
``torch.distributed``."""
