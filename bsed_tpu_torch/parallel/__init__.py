"""Data parallelism on ``torch.distributed``: the port of
``bsed_tpu/parallel/``. ``mesh`` holds the group, the batch sharding rule
and the collectives of the step; ``launch`` spawns the ranks of a group in
one process tree (tests, ``chip_smoke.py``, ``entry.dryrun_multichip``)."""
