"""Multi-GPU layer (counterpart of the JAX package's ``parallel/``): the
process-group bootstrap (``mesh.py``) and the feature exchange with its
fp8 codec (``exchange.py``). The data-parallel step comes with ROADMAP.md
Queue 1 item 17."""
