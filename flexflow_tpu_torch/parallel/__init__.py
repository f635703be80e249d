"""The PCG, strategies and their builders, the device mesh over a
``torch.distributed`` group, the parallel ops and the SPMD plan that runs
a strategy (``spmd.py``)."""
